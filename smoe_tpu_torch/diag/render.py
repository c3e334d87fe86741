"""A minimal raster renderer in numpy for the port's plotters.

It stands where matplotlib stands for the JAX package (smoe_tpu/diag/
plots.py): the card's machine has no matplotlib, so a figure is drawn here
into a uint8 RGB canvas and written through `io.images.write_png`.

A figure is one row of `Panel`s, each a tile of one size with its title
above it and, below it, one caption line per range that matplotlib's
ticks or colorbar would show.  A panel holds:

  * `Image`: (H, W) data through a colormap (`gray`, `prism`), normalised
    as imshow normalises (vmin / vmax where given, else the data's min and
    max), or (H, W, 3) RGB clipped to [0, 1]; resampled to the tile by
    nearest neighbour at its own aspect ratio;
  * `Dots` over that image, in its pixel coordinates (x a column, y a row);
  * `Hist`: the bars of `np.histogram(data, bins)`;
  * `Axis`es: line plots sharing x, each with its own y range, linear or
    log-10 (LossPlotter's twin axes), solid or dashed.

No antialiasing and no font file: text uses a fixed 5x7 bitmap font drawn
at twice its size.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from smoe_tpu_torch.io.images import write_png

SCALE = 2                       # canvas pixels per font pixel
CHAR_W = 6 * SCALE              # advance: 5 columns and one of spacing
LINE_H = 7 * SCALE + 6          # a title or caption line with its gap
PAD = 8                         # around every panel
DOT = 2                         # a scatter dot's half width
DASH, GAP = 7, 5                # a dashed line's on / off pixels

# matplotlib's single-letter colors and its default cycle's first
COLORS = {"b": (0, 0, 255), "r": (255, 0, 0), "g": (0, 128, 0),
          "k": (0, 0, 0), "C0": (31, 119, 180)}
FRAME = (128, 128, 128)


def _prism(x: np.ndarray) -> np.ndarray:
    """matplotlib's `_prism_data` (matplotlib/_cm.py), clipped as its
    lookup tables are."""
    rgb = np.stack([0.75 * np.sin((x * 20.9 + 0.25) * np.pi) + 0.67,
                    0.75 * np.sin((x * 20.9 - 0.25) * np.pi) + 0.33,
                    -1.1 * np.sin((x * 20.9) * np.pi)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


_X = np.linspace(0.0, 1.0, 256)
# 256-entry RGB lookup tables in [0, 1], as matplotlib's colormaps hold them
COLORMAPS = {"gray": np.repeat(_X[:, None], 3, axis=1), "prism": _prism(_X)}

# 5x7 glyphs: seven rows of five bits (0x10 the leftmost), two hex digits a
# row, for the characters the plotters print; any other prints as "?"
_FONT = {
    " ": "00000000000000", ".": "00000000000C0C", ",": "000000000C0408",
    ":": "000C0C000C0C00", ">": "08040201020408", "<": "02040810080402",
    "#": "0A0A1F0A1F0A0A", "_": "0000000000001F", "-": "0000001F000000",
    "+": "0004041F040400", "=": "00001F001F0000", "(": "02040808080402",
    ")": "08040202020408", "/": "00010204081000", "%": "18190204081303",
    "?": "0E110102040004",
    "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010204081F",
    "3": "1F02040201110E", "4": "02060A121F0202", "5": "1F101E0101110E",
    "6": "0608101E11110E", "7": "1F010204080808", "8": "0E11110E11110E",
    "9": "0E11110F01020C",
    "A": "0E11111F111111", "B": "1E11111E11111E", "C": "0E11101010110E",
    "D": "1C12111111121C", "E": "1F10101E10101F", "F": "1F10101E101010",
    "G": "0E11101711110F", "H": "1111111F111111", "I": "0E04040404040E",
    "J": "0702020202120C", "K": "11121418141211", "L": "1010101010101F",
    "M": "111B1515111111", "N": "11111915131111", "O": "0E11111111110E",
    "P": "1E11111E101010", "Q": "0E11111115120D", "R": "1E11111E141211",
    "S": "0F10100E01011E", "T": "1F040404040404", "U": "1111111111110E",
    "V": "11111111110A04", "W": "1111111515150A", "X": "11110A040A1111",
    "Y": "11110A04040404", "Z": "1F01020408101F",
    "a": "00000E010F110F", "b": "1010161911111E", "c": "00000E1010110E",
    "d": "01010D1311110F", "e": "00000E111F100E", "f": "0609081C080808",
    "g": "000F11110F010E", "h": "10101619111111", "i": "04000C0404040E",
    "j": "0200060202120C", "k": "10101214181412", "l": "0C04040404040E",
    "m": "00001A15151111", "n": "00001619111111", "o": "00000E1111110E",
    "p": "00001E111E1010", "q": "00000D130F0101", "r": "00001619101010",
    "s": "00000E100E011E", "t": "08081C08080906", "u": "0000111111130D",
    "v": "00001111110A04", "w": "0000111115150A", "x": "0000110A040A11",
    "y": "000011110F010E", "z": "00001F0204081F",
}


def glyph(ch: str) -> np.ndarray:
    """The (7, 5) bool bitmap of one character."""
    code = _FONT.get(ch, _FONT["?"])
    rows = [int(code[2 * i:2 * i + 2], 16) for i in range(7)]
    return np.array([[(r >> (4 - j)) & 1 for j in range(5)] for r in rows],
                    bool)


@dataclasses.dataclass
class Image:
    data: np.ndarray
    cmap: str = "gray"
    vmin: Optional[float] = None
    vmax: Optional[float] = None


@dataclasses.dataclass
class Dots:
    x: np.ndarray               # columns of the panel's image
    y: np.ndarray               # rows


@dataclasses.dataclass
class Hist:
    data: np.ndarray
    bins: int = 32


@dataclasses.dataclass
class Line:
    x: Sequence[float]
    y: Sequence[float]
    fmt: str = ""               # matplotlib's "b-", "r--"; "" = C0 solid
    label: str = ""


@dataclasses.dataclass
class Axis:
    """One y axis of a panel; a panel's axes share x."""
    lines: List[Line]
    log: bool = False
    label: str = ""
    color: str = "k"


@dataclasses.dataclass
class Panel:
    title: str
    items: list
    xlabel: str = ""


def _captions(panel: Panel) -> List[Tuple[str, str]]:
    """(text, color) of the lines under a panel: each axis's y range, the
    shared x range, a histogram's range and its tallest bar, an image's
    data range where the colormap spans it (imshow's colorbar)."""
    out = []
    axes = [it for it in panel.items if isinstance(it, Axis)]
    for ax in axes:
        y = np.concatenate([np.asarray(ln.y, np.float64).ravel()
                            for ln in ax.lines])
        lo, hi = _range(y[y > 0] if ax.log else y)
        out.append((_labelled(ax.label + (" (log)" if ax.log else ""),
                              f"{lo:.4g} - {hi:.4g}"), ax.color))
    if axes:
        lo, hi = _range(np.concatenate([np.asarray(ln.x, np.float64).ravel()
                                        for ax in axes for ln in ax.lines]))
        out.append((_labelled(panel.xlabel, f"{lo:.4g} - {hi:.4g}"), "k"))
    for it in panel.items:
        if isinstance(it, Hist):
            counts, edges = np.histogram(np.asarray(it.data), bins=it.bins)
            out.append((f"{edges[0]:.3g} - {edges[-1]:.3g} max "
                        f"{int(counts.max())}", "k"))
        elif isinstance(it, Image) and np.ndim(it.data) == 2 and (
                it.vmin is None or it.vmax is None):
            lo, hi = _range(np.asarray(it.data, np.float64))
            out.append((f"{lo:.4g} - {hi:.4g}", "k"))
    return out


def _labelled(label: str, text: str) -> str:
    return f"{label}: {text}" if label else text


def _range(v: np.ndarray) -> Tuple[float, float]:
    v = v[np.isfinite(v)]
    return (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)


def canvas_shape(panels: Sequence[Panel],
                 tile=(256, 256)) -> Tuple[int, int, int]:
    """(H, W, 3) of the figure `render` draws for these panels: a title
    line above each tile, as many caption lines below as the panel that
    has most."""
    th, tw = tile
    lines = max((len(_captions(p)) for p in panels), default=0)
    return (2 * PAD + LINE_H + th + lines * LINE_H,
            max(len(panels), 1) * (tw + 2 * PAD), 3)


def render(panels: Sequence[Panel], path: Optional[str] = None,
           tile=(256, 256)) -> np.ndarray:
    """Draw the panels in a row on a white canvas (`canvas_shape`) and
    write it as a PNG to `path` where given.  Returns the canvas."""
    canvas = np.full(canvas_shape(panels, tile), 255, np.uint8)
    th, tw = tile
    for i, panel in enumerate(panels):
        r0, c0 = PAD + LINE_H, i * (tw + 2 * PAD) + PAD
        _text(canvas, PAD, c0 + tw // 2, panel.title, "k", center=True,
              width=tw)
        _draw_panel(canvas, panel, r0, c0, th, tw)
        for j, (line, color) in enumerate(_captions(panel)):
            _text(canvas, r0 + th + 4 + j * LINE_H, c0, line, color,
                  width=tw)
    if path:
        write_png(path, canvas)
    return canvas


def _draw_panel(canvas, panel: Panel, r0, c0, th, tw) -> None:
    image = next((it for it in panel.items if isinstance(it, Image)), None)
    box = (r0, c0, th, tw)
    if image is not None:
        box = _draw_image(canvas, image, r0, c0, th, tw)
    for it in panel.items:
        if isinstance(it, Dots):
            if image is None:
                raise ValueError("Dots are drawn over a panel's Image")
            _draw_dots(canvas, it, box, np.shape(image.data)[:2])
        elif isinstance(it, Hist):
            _draw_hist(canvas, it, box)
    axes = [it for it in panel.items if isinstance(it, Axis)]
    if axes:
        _draw_axes(canvas, axes, box)
    _frame(canvas, *box)


def _frame(canvas, r0, c0, h, w) -> None:
    canvas[r0 - 1, c0 - 1:c0 + w + 1] = FRAME
    canvas[r0 + h, c0 - 1:c0 + w + 1] = FRAME
    canvas[r0 - 1:r0 + h + 1, c0 - 1] = FRAME
    canvas[r0 - 1:r0 + h + 1, c0 + w] = FRAME


def colorize(data: np.ndarray, cmap: str = "gray", vmin=None,
             vmax=None) -> np.ndarray:
    """(H, W) data -> (H, W, 3) uint8 as imshow colors it: (x - vmin) /
    (vmax - vmin) to the entry floor(256 t), clipped to the table; vmin /
    vmax default to the data's finite min and max.  NaN stays white."""
    x = np.asarray(data, np.float64)
    lo, hi = _limits(x, vmin, vmax)
    t = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    idx = np.clip(np.floor(np.nan_to_num(t, nan=0.0) * 256), 0, 255)
    rgb = np.round(COLORMAPS[cmap][idx.astype(np.int64)] * 255)
    rgb[np.isnan(x)] = 255
    return rgb.astype(np.uint8)


def _limits(x: np.ndarray, vmin, vmax) -> Tuple[float, float]:
    lo, hi = _range(x) if vmin is None or vmax is None else (0.0, 0.0)
    return (lo if vmin is None else float(vmin),
            hi if vmax is None else float(vmax))


def _draw_image(canvas, image: Image, r0, c0, th, tw):
    """The image resampled by nearest neighbour into the tile at its own
    aspect ratio, centred; returns its box (r, c, h, w).  The colormap's
    limits come from the whole image, its lookup runs on the tile's
    pixels only."""
    x = np.asarray(image.data)
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    if not (x.ndim == 2 or x.ndim == 3 and x.shape[-1] == 3):
        raise ValueError(f"an image tile needs (H, W) or (H, W, 3), got "
                         f"{x.shape}")
    h, w = x.shape[:2]
    s = min(th / h, tw / w)
    oh, ow = max(1, int(round(h * s))), max(1, int(round(w * s)))
    rows = np.minimum(((np.arange(oh) + 0.5) * h / oh).astype(int), h - 1)
    cols = np.minimum(((np.arange(ow) + 0.5) * w / ow).astype(int), w - 1)
    tile = x[rows][:, cols]
    if x.ndim == 3:
        rgb = np.round(np.clip(np.asarray(tile, np.float64), 0, 1) * 255
                       ).astype(np.uint8)
    else:
        rgb = colorize(tile, image.cmap,
                       *_limits(np.asarray(x, np.float64), image.vmin,
                                image.vmax))
    r, c = r0 + (th - oh) // 2, c0 + (tw - ow) // 2
    canvas[r:r + oh, c:c + ow] = rgb
    return r, c, oh, ow


def _draw_dots(canvas, dots: Dots, box, shape) -> None:
    r0, c0, oh, ow = box
    h, w = shape
    rr = (r0 + (np.asarray(dots.y, np.float64) + 0.5) * oh / h).astype(int)
    cc = (c0 + (np.asarray(dots.x, np.float64) + 0.5) * ow / w).astype(int)
    for r, c in zip(rr, cc):
        canvas[max(r - DOT, r0):min(r + DOT + 1, r0 + oh),
               max(c - DOT, c0):min(c + DOT + 1, c0 + ow)] = COLORS["C0"]


def _draw_hist(canvas, hist: Hist, box) -> None:
    r0, c0, h, w = box
    counts, edges = np.histogram(np.asarray(hist.data), bins=hist.bins)
    top = max(int(counts.max()), 1)
    span = edges[-1] - edges[0]
    xs = np.round((edges - edges[0]) / span * (w - 1)).astype(int) \
        if span > 0 else np.linspace(0, w - 1, len(edges)).astype(int)
    for n, a, b in zip(counts, xs[:-1], xs[1:]):
        bar = int(round(n / top * (h - 1)))
        if bar:
            canvas[r0 + h - bar:r0 + h, c0 + a:c0 + max(b, a + 1)] = \
                COLORS["C0"]


def _parse_fmt(fmt: str) -> Tuple[str, bool]:
    color = next((k for k in ("C0", "b", "r", "g", "k") if fmt.startswith(k)),
                 "C0")
    return color, "--" in fmt


def _draw_axes(canvas, axes: Sequence[Axis], box) -> None:
    """Each axis's lines on its own y range (log10 of the positive values
    on a log axis) over the panel's shared x range."""
    r0, c0, h, w = box
    xlo, xhi = _range(np.concatenate([np.asarray(ln.x, np.float64).ravel()
                                      for ax in axes for ln in ax.lines]))
    if xhi <= xlo:
        xlo, xhi = xlo - 0.5, xhi + 0.5
    for ax in axes:
        ys = []
        for ln in ax.lines:
            y = np.asarray(ln.y, np.float64)
            if ax.log:
                y = np.where(y > 0, np.log10(np.where(y > 0, y, 1.0)),
                             np.nan)
            ys.append(y)
        ylo, yhi = _range(np.concatenate([y.ravel() for y in ys]))
        pad = 0.05 * (yhi - ylo) if yhi > ylo else 0.5
        ylo, yhi = ylo - pad, yhi + pad
        for ln, y in zip(ax.lines, ys):
            color, dashed = _parse_fmt(ln.fmt)
            cc = c0 + (np.asarray(ln.x, np.float64) - xlo) / (xhi - xlo) \
                * (w - 1)
            rr = r0 + (yhi - y) / (yhi - ylo) * (h - 1)
            _polyline(canvas, rr, cc, COLORS[color], dashed, box)


def _polyline(canvas, rr, cc, color, dashed, box) -> None:
    """Segments between consecutive finite points, two pixels thick; a
    dashed line keeps DASH of every DASH + GAP pixels along its length."""
    r0, c0, h, w = box
    pts_r, pts_c = [], []
    for i in range(len(rr) - 1):
        a, b = (rr[i], cc[i]), (rr[i + 1], cc[i + 1])
        if not np.all(np.isfinite(a + b)):
            continue
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        pts_r.append(np.round(np.linspace(a[0], b[0], n)).astype(int))
        pts_c.append(np.round(np.linspace(a[1], b[1], n)).astype(int))
    if len(rr) == 1 and np.isfinite(rr[0]) and np.isfinite(cc[0]):
        pts_r, pts_c = [np.array([int(round(rr[0]))])], \
            [np.array([int(round(cc[0]))])]
    if not pts_r:
        return
    r, c = np.concatenate(pts_r), np.concatenate(pts_c)
    if dashed:
        keep = np.arange(r.size) % (DASH + GAP) < DASH
        r, c = r[keep], c[keep]
    for dr in (0, 1):
        ok = (r + dr >= r0) & (r + dr < r0 + h) & (c >= c0) & (c < c0 + w)
        canvas[r[ok] + dr, c[ok]] = color


def _text(canvas, r, c, s: str, color="k", center=False, width=None) -> None:
    """s at row r from column c (centred on c with center=True), cut to
    `width` pixels."""
    if width is not None:
        s = s[:max(width // CHAR_W, 0)]
    if center:
        c -= len(s) * CHAR_W // 2
    rgb = COLORS.get(color, COLORS["k"])
    for i, ch in enumerate(s):
        g = np.kron(glyph(ch), np.ones((SCALE, SCALE), bool))
        cc = c + i * CHAR_W
        sub = canvas[r:r + g.shape[0], cc:cc + g.shape[1]]
        sub[g[:sub.shape[0], :sub.shape[1]]] = rgb
