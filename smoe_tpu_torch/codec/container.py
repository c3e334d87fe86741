"""Model container: parameter pickles with codec metadata (from
smoe_tpu/codec/container.py).

Interchange format compatible in spirit with reference utils.py:18-65
(save_model / load_params): a pickle holding the reduced parameter dict,
loss/mse history, and the quantized-parameter dict used by the decode CLIs.
The pickle holds numpy arrays and Python values only, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np


def save_model(path: str, params: Dict[str, np.ndarray], cfg,
               qparams: Optional[Dict] = None,
               losses=None, mses=None, num_pis=None,
               reduce: bool = True, musX_grid=None,
               model_mask=None) -> None:
    """Write the codec pickle (reference utils.py:18-59).

    musX_grid: full-capacity init-grid centers when cfg.use_diff_center —
    stored (reduced like params) so reload reconstructs effective centers
    exactly.  Beyond the reference, which saves only the diffs and cannot
    decode them back (smoe.py:254 + :392)."""
    from smoe_tpu_torch.codec.quantize import reduce_params
    params = {k: np.asarray(v) for k, v in params.items()}
    used = None
    if reduce:
        params, used = reduce_params(params)

    cp = {
        "params": params,
        "mses": mses or [], "losses": losses or [], "num_pis": num_pis or [],
        "quantization_mode": cfg.quantization_mode,
        "quantized_pis": cfg.quantize_pis,
        "lower_bounds": list(cfg.lower_bounds),
        "upper_bounds": list(cfg.upper_bounds),
        "use_yuv": cfg.use_yuv, "only_y_gamma": cfg.only_y_gamma,
        "ssim_opt": cfg.ssim_opt, "use_determinant": cfg.use_determinant,
        "use_diff_center": cfg.use_diff_center,
        "kernels_per_dim": list(cfg.kernels_per_dim),
        "radial_as": cfg.radial_as,
    }
    if musX_grid is not None:
        g = np.asarray(musX_grid, np.float32)
        cp["musX_grid"] = g[used] if used is not None else g
    if model_mask is not None:
        # dual-model kernel->domain assignment, reduced like params —
        # without it a reloaded video pickle cannot rebuild the raw-domain
        # gating (the reference never round-trips this, smoe.py:280-329)
        m = np.asarray(model_mask, bool)
        cp["model_mask"] = m[used] if used is not None else m
    if cfg.dim_domain == 3 and (cfg.train_trafo or cfg.num_frames > 0):
        cp.update({"train_trafo": cfg.train_trafo,
                   "num_params_model": cfg.num_params_model,
                   "num_frames": cfg.num_frames})
    if qparams is not None:
        q = dict(qparams)
        q.update({
            "dim_of_domain": cfg.dim_domain,
            "dim_of_output": params["nu_e"].shape[-1],
            "used_ranges": False, "quantized_tria_params": True,
            "trained_gamma": cfg.train_gammas, "trained_musx": cfg.train_musx,
            "radial_as": cfg.radial_as, "trained_pis": cfg.train_pis,
            "use_yuv": cfg.use_yuv, "only_y_gamma": cfg.only_y_gamma,
            "use_determinant": cfg.use_determinant,
            "use_diff_center": cfg.use_diff_center,
        })
        if used is not None:
            q["used_kernels"] = used
        cp["qparams"] = q

    with open(path, "wb") as fd:
        pickle.dump(cp, fd)


def load_model(path: str) -> Dict:
    with open(path, "rb") as fd:
        return pickle.load(fd)


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Reference utils.py:61-65."""
    return load_model(path)["params"]
