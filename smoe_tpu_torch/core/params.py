"""SMoE parameters as a dataclass of tensors (from smoe_tpu/core/params.py:32-116).

Parameter semantics are the JAX package's (fixed capacity K; `pis <= 0`
marks a dead kernel):
    musX    (K, d)      kernel centers in [0,1]^d
    a_diag  (K, d, d)   diagonal part of the steering factor; (K,) when radial
    a_corr  (K, d, d)   strictly-lower part (zeros when radial)
    pis     (K,)        gating weights
    nu_e    (K, C)      expert offsets
    gamma_e (K, d, C)   expert slopes
    motion, sv, sv_bw_diag, sv_bw_corr   optional (video / SV residual)

`params_from_numpy` / `params_to_numpy` carry parameters between the two
packages as numpy arrays, so both compute on identical values;
`adam_state_from_numpy` carries optax's Adam moments the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoe_tpu_torch.config import SmoeConfig

FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e",
          "motion", "sv", "sv_bw_diag", "sv_bw_corr")
# names used by `Smoe.get_params()` dicts and the codec for the same fields
_DICT_NAMES = {"A_diagonal": "a_diag", "A_corr": "a_corr"}
_MOTION_ROWS = ("h11", "h12", "h13", "h21", "h22", "h23", "h31", "h32")


@dataclasses.dataclass(frozen=True)
class SmoeParams:
    """Fixed-capacity SMoE parameters (torch tensors, or numpy arrays as
    `core.init.init_params` returns them)."""

    musX: torch.Tensor
    a_diag: torch.Tensor
    a_corr: torch.Tensor
    pis: torch.Tensor
    nu_e: torch.Tensor
    gamma_e: torch.Tensor
    motion: Optional[torch.Tensor] = None
    sv: Optional[torch.Tensor] = None
    sv_bw_diag: Optional[torch.Tensor] = None
    sv_bw_corr: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.pis.shape[0]

    @property
    def dim_domain(self) -> int:
        return self.musX.shape[1]

    @property
    def num_channels(self) -> int:
        return self.nu_e.shape[1]


def params_from_numpy(d, device="cpu") -> SmoeParams:
    """Port params from the JAX package's numpy form.

    d: a `smoe_tpu` `SmoeParams` holding numpy arrays (its `to_numpy()`,
    or `init_params` output), or a dict keyed by field names or by the
    `Smoe.get_params()` names (A_diagonal / A_corr, motion rows h11..h32).
    Values are converted to float32 tensors on `device` without rounding.
    """
    if not isinstance(d, dict):
        d = {f: getattr(d, f) for f in FIELDS}
    vals = {}
    for key, v in d.items():
        name = _DICT_NAMES.get(key, key)
        if name in FIELDS and v is not None:
            vals[name] = torch.as_tensor(np.array(v, np.float32),
                                         device=device)
    if "motion" not in vals and all(r in d for r in _MOTION_ROWS):
        vals["motion"] = torch.as_tensor(
            np.stack([np.asarray(d[r], np.float32) for r in _MOTION_ROWS]),
            device=device)
    return SmoeParams(**vals)


def params_to_numpy(p: SmoeParams) -> dict:
    """Inverse of `params_from_numpy`: {field name: float32 numpy array}
    for every field that is set."""
    out = {}
    for f in FIELDS:
        v = getattr(p, f)
        if v is not None:
            out[f] = v.detach().cpu().numpy() if torch.is_tensor(v) \
                else np.asarray(v)
    return out


def _leaves(tree) -> dict:
    """{field: array} of a dict or a params-like object, keeping only
    array leaves (optax marks the fields outside a group with empty
    `MaskedNode`s, which have no shape)."""
    if not isinstance(tree, dict):
        tree = {f: getattr(tree, f, None) for f in FIELDS}
    return {_DICT_NAMES.get(k, k): v for k, v in tree.items()
            if hasattr(v, "shape") and hasattr(v, "dtype")}


def adam_state_from_numpy(mu, nu, count: int, device="cpu") -> dict:
    """optax `ScaleByAdamState` leaves as numpy -> the port's Adam state.

    mu, nu: first and second moments keyed by field (a dict, or the
    `SmoeParams`-shaped trees optax keeps, whose non-group fields are
    skipped); count: the step count.  Returns {field: {"step", "exp_avg",
    "exp_avg_sq"}}, the per-tensor state of torch.optim.Adam, which
    `Smoe.load_adam_state` installs.  Both packages then compute the same
    next step: optax.adam and torch.optim.Adam apply the same update with
    eps outside the square root, in a different op order.
    """
    mu, nu = _leaves(mu), _leaves(nu)
    out = {}
    for f, m in mu.items():
        out[f] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.array(m, np.float32),
                                       device=device),
            "exp_avg_sq": torch.as_tensor(np.array(nu[f], np.float32),
                                          device=device)}
    return out


def assemble_A(params: SmoeParams, cfg: SmoeConfig) -> torch.Tensor:
    """Build the (K, d, d) steering factor from diag + corr parts
    (params.py:89-108, reference smoe.py:714-736):
      * radial: A = a * I per kernel (a_diag is (K,))
      * else:   A = diag(a_diag) + strict_lower(a_corr)
      * train_inverse_cov additionally symmetrizes:
                A = diag + strict_lower + strict_lower^T
    """
    d = cfg.dim_domain
    eye = torch.eye(d, dtype=params.a_diag.dtype, device=params.a_diag.device)
    if cfg.radial_as:
        return params.a_diag[:, None, None] * eye[None]
    diag_entries = torch.diagonal(params.a_diag, dim1=1, dim2=2)     # (K, d)
    A = diag_entries[:, :, None] * eye[None]
    strict_lower = torch.tril(params.a_corr, diagonal=-1)
    A = A + strict_lower
    if cfg.train_inverse_cov:
        A = A + strict_lower.transpose(1, 2)
    return A


def diag_of_A(params: SmoeParams, cfg: SmoeConfig) -> torch.Tensor:
    """(K, d) diagonal of the assembled A (params.py:111-116)."""
    if cfg.radial_as:
        return params.a_diag[:, None].expand(params.capacity, cfg.dim_domain)
    return torch.diagonal(params.a_diag, dim1=1, dim2=2)
