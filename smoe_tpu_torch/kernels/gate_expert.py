"""Fused SMoE gate+expert forward: the Hopper kernel K1 and its plain version.

Counterpart of smoe_tpu/kernels/gate_expert.py (`fused_gate_expert`
forward, `gate_expert_reference` :459-471).  For every (pixel, kernel)
pair it evaluates

    maha -> exp(-0.5 maha) -> pi*det-weighted normalised gating
         -> influence cull -> affine expert mix

without materialising any (N, K) intermediate.

`gate_expert_fwd` dispatches on where its tensors lie:
  * CPU tensors go to `gate_expert_reference`, the plain torch version;
  * CUDA tensors launch the CUDA C++ kernel csrc/gate_expert_fwd.cu (built
    by kernels/build.py at first use) or raise — there is no fallback.
`gate_expert_fwd.launches` counts kernel launches (a plain int; the plain
version does not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from smoe_tpu_torch.kernels import build

_NAME = "gate_expert_fwd"


def gate_expert_reference(phi, xe, q, G, pi_det, mask, thr: float,
                          floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the fused op, in the JAX reference's op order
    (gate_expert.py:459-471).

    phi (N, F) quadratic features; xe (N, E) expert features; q (K, F)
    kernel quadratics; G (K, E*C) experts [gamma; nu]; pi_det (K,) pi*det
    (zero for dead kernels); mask (K,) float 1/0 liveness.
    Returns (res (N, C) pre-clip, surv (K,) max culled weight per kernel).
    """
    if phi.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 is on: the maha matmul needs exact "
                           "fp32")
    maha = torch.clamp(phi @ q.T, min=0.0)
    n_w = torch.exp(-0.5 * (maha * mask[None, :])) * pi_det[None, :]
    denom = torch.clamp(torch.sum(n_w, dim=1, keepdim=True), min=floor)
    w = n_w / denom
    w = torch.where(w > thr, w, torch.zeros_like(w))
    wg = w @ G
    c = G.shape[1] // xe.shape[1]
    res = sum(xe[:, j:j + 1] * wg[:, j * c:(j + 1) * c]
              for j in range(xe.shape[1]))
    surv = torch.amax(w, dim=0) if w.shape[0] else torch.zeros_like(pi_det)
    return res, surv


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load(_NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.smoe_gate_expert_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [f32, f32,
                                                                   ptr]
    lib.smoe_gate_expert_fwd.restype = i32
    lib.smoe_gate_expert_fwd_supported.argtypes = [i32, i32, i32]
    lib.smoe_gate_expert_fwd_supported.restype = i32
    lib.smoe_cuda_error_string.argtypes = [i32]
    lib.smoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"gate_expert_fwd: {name} must be a contiguous float32 tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def gate_expert_fwd(phi, xe, q, G, pi_det, mask, thr: float,
                    floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gate+expert forward; same arguments and results as
    `gate_expert_reference`.  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel (and count one launch) or raise."""
    if phi.device.type == "cpu":
        return gate_expert_reference(phi, xe, q, G, pi_det, mask, thr, floor)
    if phi.device.type != "cuda":
        raise ValueError(f"gate_expert_fwd: no kernel for {phi.device}")
    n, f = phi.shape
    e = xe.shape[1]
    k = q.shape[0]
    if e == 0 or G.shape[1] % e:
        raise ValueError(f"gate_expert_fwd: G width {G.shape[1]} is not a "
                         f"multiple of the {e} expert features")
    c = G.shape[1] // e
    dev = phi.device
    for name, t, shape in (("phi", phi, (n, f)), ("xe", xe, (n, e)),
                           ("q", q, (k, f)), ("G", G, (k, e * c)),
                           ("pi_det", pi_det, (k,)), ("mask", mask, (k,))):
        _check(name, t, shape, dev)
    lib = _library()
    if not lib.smoe_gate_expert_fwd_supported(f, e, c):
        raise ValueError(f"gate_expert_fwd: no kernel instance for F={f}, "
                         f"E={e}, C={c} (d = 2, 3, 4; C = 1 or 3)")
    # q' = -0.5 * mask * q: exact (power-of-two scale, 0/1 mask) and it
    # zeroes dead rows, so the kernel needs neither
    q_s = (q * (-0.5 * mask)[:, None]).contiguous()
    res = torch.empty((n, c), dtype=torch.float32, device=dev)
    surv = torch.zeros((k,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.smoe_gate_expert_fwd(
        phi.data_ptr(), xe.data_ptr(), q_s.data_ptr(), G.data_ptr(),
        pi_det.data_ptr(), res.data_ptr(), surv.data_ptr(),
        n, f, e, c, k, thr, floor, stream)
    if err:
        raise RuntimeError("gate_expert_fwd launch failed: "
                           + lib.smoe_cuda_error_string(err).decode())
    gate_expert_fwd.launches += 1
    return res, surv


gate_expert_fwd.launches = 0
