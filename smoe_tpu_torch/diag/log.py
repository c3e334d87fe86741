"""Run logger callbacks (from smoe_tpu/diag/log.py; reference
logger.py:11-46): params and reconstructions every validation, a full
checkpoint every 100 iterations, and a JSON-lines metrics stream.

The port runs as one process, so the JAX package's multi-host "process 0
writes" check has no counterpart here.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class ModelLogger:
    def __init__(self, path: str, as_media: bool = True,
                 checkpoint_every: int = 100):
        self.path = path
        self.as_media = as_media
        self.checkpoint_every = checkpoint_every
        for sub in ("params", "reconstructions", "checkpoints"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)

    def log(self, smoe) -> None:
        from smoe_tpu_torch.codec.container import save_model
        it = smoe.iter
        grid = None if smoe.musX_grid is None \
            else smoe.musX_grid.cpu().numpy()
        save_model(os.path.join(self.path, "params", f"{it}.pkl"),
                   smoe.get_params(), smoe.cfg, qparams=smoe.qparams,
                   losses=smoe.get_losses(), mses=smoe.get_mses(),
                   num_pis=smoe.get_num_pis(), musX_grid=grid)
        self._write(smoe.get_reconstruction(),
                    os.path.join(self.path, "reconstructions", f"{it}"), smoe)
        if smoe.cfg.quantization_mode == 1 and smoe.qvalid:
            self._write(smoe.get_qreconstruction(),
                        os.path.join(self.path, "reconstructions",
                                     f"{it}_q"), smoe)
        if self.checkpoint_every and it and it % self.checkpoint_every == 0:
            smoe.checkpoint(os.path.join(self.path, "checkpoints",
                                         f"{it}.pkl"))

    def _write(self, rec, path, smoe) -> None:
        """The reconstruction as media through io/images.write_image (log.py:
        47-57): a PNG (d = 2), a raw I420 `.yuv` (d = 3), a `.mat` light
        field (d = 4); `.npy` where write_image refuses the array (a video
        of odd size or above 8 bits) or as_media is off."""
        if self.as_media:
            from smoe_tpu_torch.io.images import write_image
            try:
                write_image(rec, path, smoe.cfg.dim_domain,
                            yuv=smoe.cfg.use_yuv,
                            precision=smoe.cfg.precision)
                return
            except ValueError:
                pass
        np.save(path + ".npy", rec)


class JsonlLogger:
    """One JSON line per validation: iteration, loss, mse, PSNR, kernel
    count and the wall time."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, smoe) -> None:
        if not smoe.get_mses():
            return
        from smoe_tpu_torch.core.losses import psnr_from_mse
        it, mse = smoe.get_mses()[-1]
        _, loss = smoe.get_losses()[-1]
        _, npi = smoe.get_num_pis()[-1]
        rec = {"iter": it, "loss": float(loss), "mse": float(mse),
               "psnr_db": psnr_from_mse(mse, smoe.cfg.precision),
               "num_kernels": int(npi), "time": time.time()}
        with open(self.path, "a") as fd:
            fd.write(json.dumps(rec) + "\n")
