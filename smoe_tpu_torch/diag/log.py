"""Run logger callbacks (from smoe_tpu/diag/log.py; reference
logger.py:11-46): params and reconstructions every validation, a full
checkpoint every 100 iterations, and a JSON-lines metrics stream.

Only rank 0 writes (log.py:25-26).  A fit over a mesh reads its params,
reconstruction and checkpoint through collectives, so there every rank
gathers them and rank 0 writes; without a mesh the other ranks return at
once.
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
        from smoe_tpu_torch.parallel.multihost import primary
        if not primary() and getattr(smoe, "mesh", None) is None:
            return
        it = smoe.iter
        params, rec = smoe.get_params(), smoe.get_reconstruction()
        qrec = smoe.get_qreconstruction() \
            if smoe.cfg.quantization_mode == 1 and smoe.qvalid else None
        if self.checkpoint_every and it and it % self.checkpoint_every == 0:
            smoe.checkpoint(os.path.join(self.path, "checkpoints",
                                         f"{it}.pkl"))
        if not primary():
            return
        grid = None if smoe.musX_grid is None \
            else smoe.musX_grid.cpu().numpy()
        save_model(os.path.join(self.path, "params", f"{it}.pkl"),
                   params, smoe.cfg, qparams=smoe.qparams,
                   losses=smoe.get_losses(), mses=smoe.get_mses(),
                   num_pis=smoe.get_num_pis(), musX_grid=grid)
        self._write(rec, os.path.join(self.path, "reconstructions", f"{it}"),
                    smoe)
        if qrec is not None:
            self._write(qrec, os.path.join(self.path, "reconstructions",
                                           f"{it}_q"), smoe)

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
        from smoe_tpu_torch.parallel.multihost import primary
        if not primary() or not smoe.get_mses():
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
