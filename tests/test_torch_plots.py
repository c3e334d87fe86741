"""PyTorch port: the plotters (smoe_tpu_torch/diag/plots.py) and their
numpy renderer (diag/render.py) against the JAX package's plotters
(smoe_tpu/diag/plots.py), which draw through matplotlib, on the CPU.

The JAX plotters run unchanged, with matplotlib's Axes methods (imshow,
hist, set_title, semilogy, plot, scatter) recorded through monkeypatch;
the port's `panels` must hand the renderer what JAX hands matplotlib:
equal titles string for string, equal image arrays with the same colormap
and limits, equal histogram data, equal curves.  `_to_display` is bit-equal
to JAX's (cv2's COLOR_YUV2RGB); the colormaps match matplotlib's tables
within 1e-6 and its imshow normalisation exactly; the PNGs read back at
`render.canvas_shape`."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401
matplotlib = pytest.importorskip("matplotlib")
pytest.importorskip("cv2")

import matplotlib.axes  # noqa: E402
import matplotlib.colors  # noqa: E402

from smoe_tpu.diag import plots as jplots  # noqa: E402
from smoe_tpu.fit import incremental as jinc  # noqa: E402
from smoe_tpu_torch.diag import plots as tplots  # noqa: E402
from smoe_tpu_torch.diag import render  # noqa: E402
from smoe_tpu_torch.fit import incremental as tinc  # noqa: E402
from smoe_tpu_torch.io.images import read_png  # noqa: E402

RECORDED = ("imshow", "hist", "set_title", "semilogy", "plot", "scatter")


@pytest.fixture
def calls(monkeypatch):
    """Every call of the RECORDED Axes methods made by the plotter (not
    from inside another: semilogy calls plot): (axes, name, args, kwargs),
    in order."""
    out, depth = [], [0]
    for name in RECORDED:
        orig = getattr(matplotlib.axes.Axes, name)

        def rec(self, *args, _name=name, _orig=orig, **kwargs):
            if not depth[0]:
                out.append((self, _name, args, kwargs))
            depth[0] += 1
            try:
                return _orig(self, *args, **kwargs)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(matplotlib.axes.Axes, name, rec)
    return out


def _titles(calls):
    """Each axes' last title, in the order the axes were first drawn on."""
    order, last = [], {}
    for ax, name, args, _ in calls:
        if ax not in last:
            order.append(ax)
            last[ax] = ""
        if name == "set_title":
            last[ax] = args[0]
    return [last[ax] for ax in order]


class _Params:
    def __init__(self, pis):
        self.pis = torch.as_tensor(pis)


class _Cfg:
    def __init__(self, use_yuv, precision=8):
        self.use_yuv, self.precision = use_yuv, precision


class Stub:
    """A trainer as the plotters read it: fixed histories, image,
    reconstruction, gating argmax, SV map and pis."""

    def __init__(self, shape=(24, 20, 3), use_yuv=True, qcurves=True,
                 sv=True, seed=0):
        rng = np.random.default_rng(seed)
        self.cfg = _Cfg(use_yuv)
        self.iter = 40
        self.image = rng.uniform(0, 1, shape).astype(np.float32)
        self._rec = np.clip(self.image + rng.normal(0, 0.02, shape), 0, 1
                            ).astype(np.float32)
        spatial = shape[:-1]
        self._wam = rng.integers(0, 16, spatial)
        self.reconstruction_sv = rng.normal(0, 0.01, spatial) if sv \
            else None
        pis = rng.uniform(0.01, 0.1, 16)
        pis[[2, 7]] = 0.0
        self.params = _Params(pis)
        its = [0, 10, 20, 30, 40]
        self._losses = [(i, float(v)) for i, v in
                        zip(its, np.geomspace(1e-2, 1e-3, 5))]
        self._mses = [(i, float(v)) for i, v in
                      zip(its, np.geomspace(500, 40, 5))]
        self._npis = [(i, n) for i, n in zip(its, [16, 16, 15, 14, 14])]
        self._qlosses = [(i, 1.1 * v) for i, v in self._losses] \
            if qcurves else []
        self._qmses = [(i, 1.2 * v) for i, v in self._mses] \
            if qcurves else []

    def get_reconstruction(self):
        return self._rec

    def get_weight_matrix_argmax(self):
        return self._wam

    def get_losses(self):
        return self._losses

    def get_qlosses(self):
        return self._qlosses

    def get_mses(self):
        return self._mses

    def get_qmses(self):
        return self._qmses

    def get_num_pis(self):
        return self._npis


def _images(panels):
    return [it for p in panels for it in p.items
            if isinstance(it, render.Image)]


def _check_imshows(calls, panels):
    shown = [(args, kw) for _, name, args, kw in calls if name == "imshow"]
    images = _images(panels)
    assert len(images) == len(shown)
    for im, (args, kw) in zip(images, shown):
        np.testing.assert_array_equal(im.data, args[0])
        assert np.asarray(im.data).dtype == np.asarray(args[0]).dtype
        assert (im.cmap, im.vmin, im.vmax) == (kw["cmap"], kw.get("vmin"),
                                               kw.get("vmax"))


# ---------------- the renderer's tables and primitives ----------------

@pytest.mark.parametrize("name", ["gray", "prism"])
def test_colormaps_match_matplotlib(name):
    ref = matplotlib.colormaps[name](np.arange(256))[:, :3]
    np.testing.assert_allclose(render.COLORMAPS[name], ref, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name,vmin,vmax", [("gray", 0, 1),
                                            ("gray", None, None),
                                            ("prism", None, None),
                                            ("gray", 0.2, 0.7)])
def test_colorize_normalises_as_imshow(name, vmin, vmax):
    """The data through imshow's Normalize and the colormap's lookup:
    the same table entry for every value, the limits included."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.1, 1.1, (17, 13))
    x[0, :3] = [0.0, 1.0, 0.5]
    norm = matplotlib.colors.Normalize(vmin, vmax)
    ref = matplotlib.colormaps[name](norm(x))[..., :3]
    np.testing.assert_array_equal(render.colorize(x, name, vmin, vmax),
                                  np.round(ref * 255).astype(np.uint8))


def test_font_covers_what_the_plotters_print():
    printed = ("orig reconstruction gating supportvectors pis_hist rec dB "
               "pis > 0: clean noisy denoised PSNR vs clean num peaks: "
               "loss qloss mse qmse #kernels iteration (log) 0123456789.-+e")
    missing = sorted({c for c in printed if c not in render._FONT})
    assert not missing
    assert render.glyph("?").sum() and not render.glyph(" ").any()
    # every glyph a distinct bitmap
    maps = {render.glyph(c).tobytes() for c in render._FONT}
    assert len(maps) == len(render._FONT)


def test_render_draws_lines_bars_dots_and_text(tmp_path):
    """Solid and dashed lines on a linear and a log axis, histogram bars
    and dots land inside their tiles; the PNG holds the canvas."""
    x = np.arange(10.0)
    panels = [
        render.Panel("lines", [render.Axis([render.Line(x, x, "b-"),
                                            render.Line(x, x[::-1], "r--")]),
                               render.Axis([render.Line(x, 1 + x ** 3, "g-")],
                                           log=True)], xlabel="iteration"),
        render.Panel("hist", [render.Hist(np.linspace(0, 1, 100), 32)]),
        render.Panel("dots", [render.Image(np.zeros((8, 8)), "gray", 0, 1),
                              render.Dots(np.array([1, 6]),
                                          np.array([2, 5]))])]
    path = str(tmp_path / "f.png")
    canvas = render.render(panels, path, tile=(64, 96))
    assert canvas.shape == render.canvas_shape(panels, (64, 96))
    np.testing.assert_array_equal(read_png(path)[..., ::-1], canvas)
    for color in ("b", "r", "g", "C0"):
        assert (canvas == render.COLORS[color]).all(-1).any(), color
    # the dashed red line has fewer pixels than the solid blue one
    assert ((canvas == render.COLORS["r"]).all(-1).sum()
            < (canvas == render.COLORS["b"]).all(-1).sum())
    with pytest.raises(ValueError, match="Dots"):
        render.render([render.Panel("", [render.Dots([0], [0])])])


# ---------------- _to_display ----------------

@pytest.mark.parametrize("shape", [(9, 7, 3), (9, 7, 4, 3), (3, 3, 5, 4, 3),
                                   (9, 7, 1)])
@pytest.mark.parametrize("use_yuv", [True, False])
def test_to_display_is_bit_equal(shape, use_yuv):
    img = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    j = jplots._to_display(img, use_yuv)
    t = tplots._to_display(img, use_yuv)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


# ---------------- the plotters ----------------

IMAGE_OPTIONS = {
    "default": ("orig", "reconstruction", "gating", "pis_hist"),
    "svs": ("orig", "reconstruction", "gating", "supportvectors",
            "pis_hist"),
}
STUBS = {
    "rgb_yuv": dict(),
    "gray": dict(shape=(24, 20, 1), use_yuv=False),
    "video": dict(shape=(12, 10, 3, 3)),
    "lf": dict(shape=(3, 3, 8, 6, 1), use_yuv=False),
    "no_sv_no_q": dict(sv=False, qcurves=False),
}


@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("options", sorted(IMAGE_OPTIONS))
def test_image_plotter_panels_match_jax(calls, tmp_path, stub, options):
    s = Stub(**STUBS[stub])
    opts = IMAGE_OPTIONS[options]
    jplots.ImagePlotter(path=str(tmp_path / "jax"), options=opts).plot(s)
    tp = tplots.ImagePlotter(path=str(tmp_path / "torch"), options=opts)
    panels = tp.panels(s)
    assert [p.title for p in panels] == _titles(calls)
    assert panels[1].title == f"rec {jplots.psnr(s._mses[-1][1]):.2f} dB"
    _check_imshows(calls, panels)
    hists = [(args, kw) for _, name, args, kw in calls if name == "hist"]
    (hargs, hkw), = hists
    hist = next(it for p in panels for it in p.items
                if isinstance(it, render.Hist))
    np.testing.assert_array_equal(hist.data, hargs[0])
    assert hist.bins == hkw["bins"] == 32
    # matplotlib's bars are np.histogram's
    n, edges = np.histogram(hist.data, bins=32)
    ax = next(a for a, name, _, _ in calls if name == "hist")
    np.testing.assert_array_equal(
        [patch.get_height() for patch in ax.patches], n)
    # the PNG of the same call, at the stated size
    tp.plot(s)
    out = read_png(str(tmp_path / "torch" / "iter_40.png"))
    assert out.shape == render.canvas_shape(panels, tplots.TILE)
    assert set(os.listdir(tmp_path / "torch")) == \
        set(os.listdir(tmp_path / "jax"))


def test_image_plotter_orig_tile_is_the_displayed_image(tmp_path):
    """The orig tile of the written PNG is _to_display(image) through the
    gray map at 0..1, resampled by nearest neighbour."""
    s = Stub(shape=(32, 32, 3))
    tp = tplots.ImagePlotter(path=str(tmp_path), options=("orig",))
    tp.plot(s)
    png = read_png(str(tmp_path / "iter_40.png"))[..., ::-1]
    r0, c0 = render.PAD + render.LINE_H, render.PAD
    tile = png[r0:r0 + 256, c0:c0 + 256]
    disp = tplots._to_display(s.image, True)
    want = np.round(np.clip(disp, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tile[::8, ::8], want)


@pytest.mark.parametrize("qcurves", [True, False])
def test_loss_plotter_curves_match_jax(calls, tmp_path, qcurves):
    s = Stub(qcurves=qcurves)
    jplots.LossPlotter(path=str(tmp_path / "jax" / "loss.png")).plot(s)
    tp = tplots.LossPlotter(path=str(tmp_path / "torch" / "loss.png"))
    (panel,) = tp.panels(s)
    drawn = [(ax, name, args, kw) for ax, name, args, kw in calls
             if name in ("semilogy", "plot")]
    # one matplotlib axes per port Axis, in order; semilogy = log
    axes_j = []
    for ax, name, _, _ in drawn:
        if ax not in axes_j:
            axes_j.append(ax)
    assert len(axes_j) == len(panel.items) == 3
    for axis, ax_j in zip(panel.items, axes_j):
        mine = [(name, args, kw) for a, name, args, kw in drawn
                if a is ax_j]
        assert len(mine) == len(axis.lines)
        for line, (name, args, kw) in zip(axis.lines, mine):
            assert axis.log == (name == "semilogy")
            x, y, fmt = args
            assert (list(line.x), list(line.y)) == (list(x), list(y))
            assert (line.fmt, line.label) == (fmt, kw["label"])
    assert [a.label for a in panel.items] == ["loss", "mse", "#kernels"]
    tp.plot(s)
    out = read_png(str(tmp_path / "torch" / "loss.png"))
    assert out.shape == render.canvas_shape([panel], tplots.LOSS_TILE)


def test_loss_plotter_without_losses_writes_nothing(tmp_path):
    s = Stub()
    s._losses = []
    tp = tplots.LossPlotter(path=str(tmp_path / "loss.png"))
    assert tp.panels(s) == [] and tp.plot(s) is None
    assert not os.path.exists(tmp_path / "loss.png")


@pytest.mark.parametrize("stub", ["rgb_yuv", "gray"])
def test_denoise_plotter_panels_match_jax(calls, tmp_path, stub):
    """Two calls: the PSNR track grows by one point each."""
    s = Stub(**STUBS[stub])
    clean = np.clip(s.image + 0.01, 0, 1)
    jp = jplots.DenoisePlotter(clean, path=str(tmp_path / "jax"))
    tp = tplots.DenoisePlotter(clean, path=str(tmp_path / "torch"))
    for it in (40, 50):
        s.iter = it
        del calls[:]
        jp.plot(s)
        panels = tp.panels(s)
        assert tp.psnrs == jp.psnrs and len(tp.psnrs) == it // 10 - 3
        assert [p.title for p in panels] == _titles(calls)
        _check_imshows(calls, panels)
        (_, _, args, _), = [c for c in calls if c[1] == "plot"]
        (line,) = panels[3].items[0].lines
        assert (list(line.x), list(line.y)) == (list(args[0]),
                                                list(args[1]))
    tp.plot(s)
    out = read_png(str(tmp_path / "torch" / "denoise_50.png"))
    assert out.shape == render.canvas_shape(panels, tplots.TILE)
    assert set(os.listdir(tmp_path / "torch")) >= {"denoise_50.png"}


# ---------------- the inc loop's peak plot ----------------

@pytest.mark.parametrize("n_peaks", [0, 5])
@pytest.mark.parametrize("channels", [None, 2])
def test_peak_plot_matches_jax(calls, tmp_path, n_peaks, channels):
    rng = np.random.default_rng(3)
    shape = (20, 24) if channels is None else (20, 24, channels)
    diff = rng.uniform(0, 0.3, shape)
    peaks = rng.integers(0, 20, (n_peaks, 2))
    jinc._plot_peaks(diff, peaks, str(tmp_path / "jax"), 7)
    tinc._plot_peaks(diff, peaks, str(tmp_path / "torch"), 7)
    panels = tinc.peak_panels(diff, peaks)
    assert [p.title for p in panels] == _titles(calls) == \
        [f"num peaks: {n_peaks}"]
    _check_imshows(calls, panels)
    scattered = [args for _, name, args, _ in calls if name == "scatter"]
    dots = [it for it in panels[0].items if isinstance(it, render.Dots)]
    assert len(dots) == len(scattered) == (1 if n_peaks else 0)
    for d, (x, y) in zip(dots, scattered):
        np.testing.assert_array_equal(d.x, x)
        np.testing.assert_array_equal(d.y, y)
    assert os.listdir(tmp_path / "torch") == os.listdir(tmp_path / "jax") \
        == ["inc_7.png"]
    out = read_png(str(tmp_path / "torch" / "inc_7.png"))
    assert out.shape == render.canvas_shape(panels)
