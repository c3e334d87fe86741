"""Diagnostic plotters, callback objects taking the trainer (from
smoe_tpu/diag/plots.py; reference plotter.py):
  ImagePlotter (orig / reconstruction / gating argmax / SV map / pi
  histogram), LossPlotter (loss, mse and kernel count on three y axes,
  the quantized curves dashed), DenoisePlotter (clean / noisy / denoised
  and the PSNR-to-clean track).
Each is plugged in through `Smoe.train(callbacks=[plotter.plot])`.

Each plotter splits what it draws from the drawing: `panels(smoe)` returns
the panels (titles, arrays, histogram data, curves) as the JAX plotter
hands them to matplotlib, and `plot(smoe)` draws them with the port's numpy
renderer (diag/render.py) into a PNG.  `quiet` is accepted for the JAX
signature: there is no display to show a figure on, as there is none for
JAX's plt.show() under its Agg backend.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from smoe_tpu_torch.core.losses import psnr_from_mse
from smoe_tpu_torch.diag.render import (Axis, Hist, Image, Line, Panel,
                                        render)
from smoe_tpu_torch.io.images import yuv_to_bgr

TILE = (256, 256)           # an image panel, in canvas pixels
LOSS_TILE = (320, 640)      # LossPlotter's one panel


def psnr(mse: float, precision: int = 8) -> float:
    """Reference plotter.py:14-15."""
    return psnr_from_mse(mse, precision)


def _to_display(img: np.ndarray, use_yuv: bool) -> np.ndarray:
    """YUV -> RGB in [0, 1] for display (cv2's COLOR_YUV2RGB of the 8-bit
    values, bit for bit) for an image, a video (H, W, T, 3) or a light
    field (U, V, H, W, 3); anything else squeezed (plots.py:29-48)."""
    img = np.asarray(img)
    if img.ndim in (3, 4, 5) and img.shape[-1] == 3 and use_yuv:
        u8 = np.uint8(np.clip(np.round(img * 255), 0, 255))
        return yuv_to_bgr(u8)[..., ::-1] / 255.0
    return np.squeeze(img)


class ImagePlotter:
    """Panels: original / reconstruction / gating / SV map / pi histogram,
    written as `iter_{smoe.iter}.png` in `path`."""

    def __init__(self, path: Optional[str] = None,
                 options: Sequence[str] = ("orig", "reconstruction",
                                           "gating", "pis_hist"),
                 quiet: bool = True):
        self.path = path
        self.options = list(options)
        self.quiet = quiet
        if path:
            os.makedirs(path, exist_ok=True)

    def panels(self, smoe) -> List[Panel]:
        use_yuv = smoe.cfg.use_yuv
        out = []
        for opt in self.options:
            title, items = opt, []
            if opt == "orig":
                img = _to_display(smoe.image, use_yuv)
                items.append(Image(self._frame0(img), "gray", 0, 1))
            elif opt == "reconstruction":
                rec = smoe.get_reconstruction()
                if smoe.get_mses():
                    mse = smoe.get_mses()[-1][1]
                    title = f"rec {psnr(mse, smoe.cfg.precision):.2f} dB"
                items.append(Image(self._frame0(_to_display(rec, use_yuv)),
                                   "gray", 0, 1))
            elif opt == "gating":
                w = smoe.get_weight_matrix_argmax()
                items.append(Image(self._frame0(np.squeeze(w)), "prism"))
            elif opt == "supportvectors":
                sv = getattr(smoe, "reconstruction_sv", None)
                if sv is not None:
                    items.append(Image(self._frame0(np.squeeze(sv)),
                                       "gray"))
            elif opt == "pis_hist":
                pis = smoe.params.pis.detach().cpu().numpy()
                items.append(Hist(pis[pis > 0], bins=32))
                title = f"pis > 0: {(pis > 0).sum()}"
            out.append(Panel(title, items))
        return out

    def plot(self, smoe) -> np.ndarray:
        path = os.path.join(self.path, f"iter_{smoe.iter}.png") \
            if self.path else None
        return render(self.panels(smoe), path, TILE)

    @staticmethod
    def _frame0(img):
        """For video volumes frame 0; for a light field the center view."""
        if img.ndim == 5:                      # (U, V, H, W, C) light field
            return img[img.shape[0] // 2, img.shape[1] // 2]
        if img.ndim == 4:
            if img.shape[-1] in (1, 3):        # (H, W, T, C) video
                return img[:, :, 0]
            return img[img.shape[0] // 2, img.shape[1] // 2]   # gray LF
        if img.ndim == 3 and img.shape[-1] not in (1, 3):
            return img[:, :, 0]                # squeezed grayscale video
        return img


class LossPlotter:
    """Loss and mse (log y, the quantized curves dashed) and the kernel
    count on three y axes sharing the iteration, written to `path`."""

    def __init__(self, path: Optional[str] = None, quiet: bool = True):
        self.path = path
        self.quiet = quiet
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def panels(self, smoe) -> List[Panel]:
        losses = smoe.get_losses()
        if not losses:
            return []
        loss = [Line(*zip(*losses), "b-", "loss")]
        if smoe.get_qlosses():
            loss.append(Line(*zip(*smoe.get_qlosses()), "b--", "qloss"))
        mse = [Line(*zip(*smoe.get_mses()), "r-", "mse")]
        if smoe.get_qmses():
            mse.append(Line(*zip(*smoe.get_qmses()), "r--", "qmse"))
        kernels = [Line(*zip(*smoe.get_num_pis()), "g-", "#kernels")]
        return [Panel("", [Axis(loss, True, "loss", "b"),
                           Axis(mse, True, "mse", "r"),
                           Axis(kernels, False, "#kernels", "g")],
                      xlabel="iteration")]

    def plot(self, smoe) -> Optional[np.ndarray]:
        panels = self.panels(smoe)
        if not panels:
            return None
        return render(panels, self.path, LOSS_TILE)


class DenoisePlotter:
    """Denoising: clean / noisy / denoised panels and the PSNR-to-clean
    track, written as `denoise_{smoe.iter}.png` in `path`.  Each `panels`
    call adds the current PSNR to the track."""

    def __init__(self, clean_image: np.ndarray, path: Optional[str] = None,
                 quiet: bool = True):
        self.clean = np.asarray(clean_image)
        self.path = path
        self.quiet = quiet
        self.psnrs = []
        if path:
            os.makedirs(path, exist_ok=True)

    def panels(self, smoe) -> List[Panel]:
        rec = smoe.get_reconstruction()
        mse = float(np.mean((rec - self.clean) ** 2))
        p = psnr(mse * (2 ** smoe.cfg.precision) ** 2, smoe.cfg.precision)
        self.psnrs.append((smoe.iter, p))
        use_yuv = smoe.cfg.use_yuv
        out = [Panel(title, [Image(np.squeeze(_to_display(img, use_yuv)),
                                   "gray", 0, 1)])
               for title, img in (("clean", self.clean),
                                  ("noisy", smoe.image),
                                  (f"denoised {p:.2f} dB", rec))]
        track = Line(*zip(*self.psnrs))
        return out + [Panel("PSNR vs clean", [Axis([track])])]

    def plot(self, smoe) -> np.ndarray:
        path = os.path.join(self.path, f"denoise_{smoe.iter}.png") \
            if self.path else None
        return render(self.panels(smoe), path, TILE)
