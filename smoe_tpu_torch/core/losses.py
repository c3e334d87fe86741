"""Loss helpers of the port (from smoe_tpu/core/losses.py:101-106).

Only `psnr_from_mse` is carried over for the serving slice; the training
losses wait for the trainer slice.
"""

from __future__ import annotations

import numpy as np


def psnr_from_mse(mse: float, precision: int) -> float:
    """PSNR given the pre-scaled MSE (reference plotter.py:14-15).
    A perfect reconstruction (mse == 0) reports the ~144 dB f32 ceiling
    instead of dividing by zero."""
    return float(10.0 * np.log10((2 ** precision) ** 2 / max(mse, 1e-12)))
