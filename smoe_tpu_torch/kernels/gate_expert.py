"""Fused SMoE gate+expert op: the Hopper kernels K1 (forward) and K2
(backward), their plain versions, and the autograd op around them.

Counterpart of smoe_tpu/kernels/gate_expert.py (`fused_gate_expert`
:377-452, `gate_expert_reference` :459-471).  For every (pixel, kernel)
pair the forward evaluates

    maha -> exp(-0.5 maha) -> pi*det-weighted normalised gating
         -> influence cull -> affine expert mix

without materialising any (N, K) intermediate; the backward recomputes
that chain and accumulates dq', dG and dpi_det over the pixels
(_bwd_kernel :236-314).

`gate_expert_fwd` and `gate_expert_bwd` dispatch on where their tensors
lie:
  * CPU tensors go to `gate_expert_reference` / `gate_expert_bwd_reference`,
    the plain torch versions;
  * CUDA tensors launch the CUDA C++ kernels csrc/gate_expert_fwd.cu /
    csrc/gate_expert_bwd.cu (built by kernels/build.py at first use) or
    raise — there is no fallback.
`gate_expert_fwd.launches` / `gate_expert_bwd.launches` count kernel
launches (plain ints; the plain versions do not count), bf16 ones
included; `.launches_bf16` counts the bf16 ones again.  A CUDA graph
replays launches without running the wrappers: `launch_counts`,
`bf16_launch_counts` and `add_launches` let a graph take back what its
capture counted and add it at each replay (fit/graph.py).

bf16 (compute_dtype="bfloat16", the TPU kernels' static `bf16` argument,
gate_expert.py:121-123, 246-247): phi and q' are rounded to bf16 for the
maha product alone, whose products are then exact and summed in fp32; the
exp, the denominator, the cull, the expert mix and every backward sum stay
fp32, and dq' sums over the fp32 phi (:300).  The kernels take the maha
from the bf16 tensor core (mma.sync, csrc/gate_expert_common.cuh); the
plain versions from an fp32 product of the rounded operands.  The op's
gradients leave it in fp32, unrounded, as the custom VJP returns them.

On the card the backward reuses the forward's work: `GateExpert` has K1
write each pixel's gating denominator into an (N,) buffer and hands it to
K2, which reads it instead of summing it again.  Both kernels skip the division for every pair that is
certainly culled (n_w below thr * denom less a 2^-20 margin; see
csrc/gate_expert_common.cuh), and K1 visits in its second pass only the
kernels that may survive somewhere in its CTA, which keeps its bits.

Gradient semantics are the JAX op's (gate_expert.py:38-42, 283-297): the
cull mask and the denominator floor are straight-through constants, and
the maha >= 0 clamp takes jnp.minimum's subgradient (1 below the tie, 0.5
at it, 0 where clamped).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from smoe_tpu_torch.kernels import build

_NAME = "gate_expert_fwd"
_BWD_NAME = "gate_expert_bwd"


def _refuse_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("allow_tf32 is on: the maha matmul needs exact "
                           "fp32")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _maha_operands(phi, q, bf16: bool):
    """phi and q (or q') as the maha product takes them: rounded to bf16
    when `bf16`, whose products are then exact in the fp32 product."""
    return (round_bf16(phi), round_bf16(q)) if bf16 else (phi, q)


def _plain_gate(phi, q, pi_det, mask, floor: float, bf16: bool = False):
    """(n_w (N, K), denom (N, 1)) in the JAX reference's op order."""
    _refuse_tf32(phi)
    phi_m, q_m = _maha_operands(phi, q, bf16)
    # torch.maximum against a 0-dim constant: 0.5 gradient at a tie, as
    # jnp.maximum (torch.clamp would give 1)
    maha = torch.maximum(phi_m @ q_m.T, phi.new_zeros(()))
    n_w = torch.exp(-0.5 * (maha * mask[None, :])) * pi_det[None, :]
    denom = torch.maximum(phi.new_full((), floor),
                          torch.sum(n_w, dim=1, keepdim=True))
    return n_w, denom


def gate_expert_reference(phi, xe, q, G, pi_det, mask, thr: float,
                          floor: float, bf16: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the fused op, in the JAX reference's op order
    (gate_expert.py:459-471).

    phi (N, F) quadratic features; xe (N, E) expert features; q (K, F)
    kernel quadratics; G (K, E*C) experts [gamma; nu]; pi_det (K,) pi*det
    (zero for dead kernels); mask (K,) float 1/0 liveness; bf16: phi and q
    rounded to bf16 for the maha (rounding q is rounding the kernel's
    q' = -0.5 * mask * q: the scale is a power of two).
    Returns (res (N, C) pre-clip, surv (K,) max culled weight per kernel).
    """
    n_w, denom = _plain_gate(phi, q, pi_det, mask, floor, bf16)
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
    for fn in (lib.smoe_gate_expert_fwd, lib.smoe_gate_expert_fwd_bf16):
        fn.argtypes = [ptr] * 9 + [i32] * 5 + [f32, f32, ptr]
        fn.restype = i32
    lib.smoe_gate_expert_fwd_supported.argtypes = [i32, i32, i32]
    lib.smoe_gate_expert_fwd_supported.restype = i32
    lib.smoe_cuda_error_string.argtypes = [i32]
    lib.smoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"gate_expert: {name} must be a contiguous float32 tensor "
            f"of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def gate_expert_fwd(phi, xe, q, G, pi_det, mask, thr: float, floor: float,
                    denom_out=None, stats=None,
                    bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gate+expert forward; same arguments and results as
    `gate_expert_reference`.  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel (its bf16 instance when `bf16`; one
    launch counted) or raise.

    Kernel outputs, CUDA only: denom_out, an (N,) float32 tensor that
    receives each pixel's gating denominator max(floor, sum_k n_w), for
    `gate_expert_bwd`'s `denom`; stats, an int64 (2,) tensor to which the
    kernel adds (pairs its second pass visited, pairs that survived the
    cull).  Any K: the kernel takes the kernels in segments of 8192."""
    if phi.device.type == "cpu":
        if stats is not None or denom_out is not None:
            raise ValueError("gate_expert_fwd: denom_out and stats are the "
                             "kernel's outputs; CPU tensors take the plain "
                             "version")
        return gate_expert_reference(phi, xe, q, G, pi_det, mask, thr, floor,
                                     bf16)
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
    if denom_out is not None:
        _check("denom_out", denom_out, (n,), dev)
    if stats is not None and (stats.device != dev
                              or stats.dtype != torch.int64
                              or tuple(stats.shape) != (2,)):
        raise ValueError("gate_expert_fwd: stats must be an int64 tensor of "
                         f"shape (2,) on {dev}")
    lib = _library()
    if not lib.smoe_gate_expert_fwd_supported(f, e, c):
        raise ValueError(f"gate_expert_fwd: no kernel instance for F={f}, "
                         f"E={e}, C={c} (d = 2, 3, 4 or the dual-model "
                         "F = 26; C = 1 or 3)")
    # q' = -0.5 * mask * q: exact (power-of-two scale, 0/1 mask) and it
    # zeroes dead rows, so the kernel needs neither
    q_s = (q * (-0.5 * mask)[:, None]).contiguous()
    res = torch.empty((n, c), dtype=torch.float32, device=dev)
    surv = torch.zeros((k,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = (lib.smoe_gate_expert_fwd_bf16 if bf16
              else lib.smoe_gate_expert_fwd)
    err = launch(
        phi.data_ptr(), xe.data_ptr(), q_s.data_ptr(), G.data_ptr(),
        pi_det.data_ptr(), res.data_ptr(), surv.data_ptr(),
        None if denom_out is None else denom_out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        n, f, e, c, k, thr, floor, stream)
    if err:
        raise RuntimeError("gate_expert_fwd launch failed: "
                           + lib.smoe_cuda_error_string(err).decode())
    gate_expert_fwd.launches += 1
    gate_expert_fwd.launches_bf16 += bool(bf16)
    return res, surv


gate_expert_fwd.launches = 0
gate_expert_fwd.launches_bf16 = 0


def gate_expert_bwd_reference(phi, xe, q_s, G, pi_det, g, thr: float,
                              floor: float, denom=None, bf16: bool = False):
    """Plain torch backward of the fused op in `_bwd_kernel`'s op order
    (gate_expert.py:249-302): recomputes the forward, then returns
    (dq' (K, F) with respect to the PRESCALED q' = -0.5 * mask * q,
    dG (K, E*C), dpi_det (K,)) for the cotangent g (N, C) of res.

    denom: the (N,) gating denominator max(floor, sum_k n_w) when the
    caller has it (the forward's); it must equal what is recomputed here
    otherwise.  live = raw > floor is then denom > floor, the same test.
    bf16: the recomputed maha from phi and q' rounded to bf16 (:246-247);
    dq' sums over the fp32 phi (:300)."""
    _refuse_tf32(phi)
    e_dim = xe.shape[1]
    phi_m, q_m = _maha_operands(phi, q_s, bf16)
    mh_raw = phi_m @ q_m.T
    mh = torch.minimum(mh_raw, phi.new_zeros(()))   # maha >= 0 clamp
    e_term = torch.exp(mh)
    n_w = e_term * pi_det[None, :]
    if denom is None:
        raw = torch.sum(n_w, dim=1, keepdim=True)
        denom = torch.maximum(phi.new_full((), floor), raw)
        live = (raw > floor).float()
    else:
        denom = denom[:, None]
        live = (denom > floor).float()
    w_tilde = n_w / denom
    cull = (w_tilde > thr).float()
    w = w_tilde * cull
    dwg = torch.cat([xe[:, j:j + 1] * g for j in range(e_dim)], dim=1)
    dG = w.T @ dwg
    dwt = (dwg @ G.T) * cull                    # cull is straight-through
    s = torch.sum(dwt * w_tilde, dim=1, keepdim=True)
    dn_w = (dwt - s * live) / denom
    dpi = torch.sum(dn_w * e_term, dim=0)
    clamp_f = 0.5 * ((mh_raw < 0).float() + (mh_raw <= 0).float())
    dq = (dn_w * n_w * clamp_f).T @ phi
    return dq, dG, dpi


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = build.load(_BWD_NAME)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.smoe_gate_expert_bwd, lib.smoe_gate_expert_bwd_bf16):
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [f32, f32, ptr, ptr]
        fn.restype = i32
    lib.smoe_gate_expert_bwd_workspace.argtypes = [i32, i32, i32, i32, i32]
    lib.smoe_gate_expert_bwd_workspace.restype = ctypes.c_longlong
    lib.smoe_gate_expert_bwd_supported.argtypes = [i32, i32, i32]
    lib.smoe_gate_expert_bwd_supported.restype = i32
    lib.smoe_cuda_error_string.argtypes = [i32]
    lib.smoe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gate_expert_bwd(phi, xe, q_s, G, pi_det, g, thr: float, floor: float,
                    denom=None, bf16: bool = False):
    """Fused gate+expert backward; same arguments and results as
    `gate_expert_bwd_reference`.  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel K2 (its bf16 instance when `bf16`; one
    launch counted) or raise.

    denom: the (N,) denominator `gate_expert_fwd` wrote into its
    `denom_out` for the same phi, q' and pi_det.  The kernel reads it and
    does not sum it again, so on CUDA tensors it is required (`GateExpert`
    passes it).  The kernel sums over pixels in a fixed order (per-CTA
    partials, then a second pass over them), so two runs on the same
    inputs give the same bits."""
    if phi.device.type == "cpu":
        return gate_expert_bwd_reference(phi, xe, q_s, G, pi_det, g, thr,
                                         floor, denom, bf16)
    if phi.device.type != "cuda":
        raise ValueError(f"gate_expert_bwd: no kernel for {phi.device}")
    n, f = phi.shape
    e = xe.shape[1]
    k = q_s.shape[0]
    c = g.shape[1]
    ec = e * c
    dev = phi.device
    for name, t, shape in (("phi", phi, (n, f)), ("xe", xe, (n, e)),
                           ("q_s", q_s, (k, f)), ("G", G, (k, ec)),
                           ("pi_det", pi_det, (k,)), ("g", g, (n, c))):
        _check(name, t, shape, dev)
    if denom is None:
        raise ValueError("gate_expert_bwd: CUDA tensors need the forward's "
                         "denominator: pass gate_expert_fwd's denom_out as "
                         "denom")
    _check("denom", denom, (n,), dev)
    lib = _bwd_library()
    if not lib.smoe_gate_expert_bwd_supported(f, e, c):
        raise ValueError(f"gate_expert_bwd: no kernel instance for F={f}, "
                         f"E={e}, C={c} (d = 2, 3, 4 or the dual-model "
                         "F = 26; C = 1 or 3)")
    dq = torch.empty((k, f), dtype=torch.float32, device=dev)
    dG = torch.empty((k, ec), dtype=torch.float32, device=dev)
    dpi = torch.empty((k,), dtype=torch.float32, device=dev)
    # scratch: per-pixel (denom, cut, s * live, dn0) and the per-CTA
    # partial sums; the kernel allocates nothing itself
    ws = torch.empty((int(lib.smoe_gate_expert_bwd_workspace(n, f, e, c,
                                                             k)),),
                     dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = (lib.smoe_gate_expert_bwd_bf16 if bf16
              else lib.smoe_gate_expert_bwd)
    err = launch(
        phi.data_ptr(), xe.data_ptr(), q_s.data_ptr(), G.data_ptr(),
        pi_det.data_ptr(), g.data_ptr(), denom.data_ptr(), dq.data_ptr(),
        dG.data_ptr(), dpi.data_ptr(), n, f, e, c, k, thr, floor,
        ws.data_ptr(), stream)
    if err:
        raise RuntimeError("gate_expert_bwd launch failed: "
                           + lib.smoe_cuda_error_string(err).decode())
    gate_expert_bwd.launches += 1
    gate_expert_bwd.launches_bf16 += bool(bf16)
    return dq, dG, dpi


gate_expert_bwd.launches = 0
gate_expert_bwd.launches_bf16 = 0


def launch_counts() -> Tuple[int, int]:
    """(K1, K2) launches counted so far, bf16 ones included."""
    return gate_expert_fwd.launches, gate_expert_bwd.launches


def bf16_launch_counts() -> Tuple[int, int]:
    """(K1, K2) launches of the bf16 instances counted so far."""
    return gate_expert_fwd.launches_bf16, gate_expert_bwd.launches_bf16


def add_launches(k1: int, k2: int, k1_bf16: int = 0,
                 k2_bf16: int = 0) -> None:
    """Add launches the wrappers did not count (a graph's replay) or take
    back ones that did not run (a capture); k1_bf16 and k2_bf16 are those
    of the bf16 instances among them, which k1 and k2 include."""
    gate_expert_fwd.launches += k1
    gate_expert_bwd.launches += k2
    gate_expert_fwd.launches_bf16 += k1_bf16
    gate_expert_bwd.launches_bf16 += k2_bf16


class GateExpert(torch.autograd.Function):
    """The fused op with its recompute backward: counterpart of the custom
    VJP `fused_gate_expert` (gate_expert.py:377-452).

    apply(phi, xe, q, G, pi_det, mask, thr, floor[, bf16]) -> (res (N, C)
    pre-clip, surv (K,)); bf16 rounds phi and q' for the maha, in K1 and
    in K2's recomputation, and the gradients stay fp32.  Saves the same
    residuals as `_fused_fwd` (:427-431) and
    recomputes the (pixel, kernel) chain in the backward; gradients flow to
    q, G and pi_det only (phi, xe and mask get none; surv carries none).
    On the card it also saves K1's (N,) gating denominator, which K2 reads
    instead of summing it again; a call that needs no gradient (the
    decode) does not write it, and on the CPU the plain backward
    recomputes it in its own op order."""

    @staticmethod
    def forward(ctx, phi, xe, q, G, pi_det, mask, thr, floor, bf16=False):
        denom = None
        if phi.is_cuda and any(ctx.needs_input_grad[2:5]):
            denom = torch.empty((phi.shape[0],), dtype=torch.float32,
                                device=phi.device)
        res, surv = gate_expert_fwd(phi, xe, q, G, pi_det, mask, thr, floor,
                                    denom_out=denom, bf16=bf16)
        ctx.save_for_backward(phi, xe, q, G, pi_det, mask, denom)
        ctx.thr, ctx.floor, ctx.bf16 = thr, floor, bool(bf16)
        ctx.mark_non_differentiable(surv)
        return res, surv

    @staticmethod
    def backward(ctx, g_res, g_surv):
        phi, xe, q, G, pi_det, mask, denom = ctx.saved_tensors
        scale = (-0.5 * mask)[:, None]
        # the forward's prescale, recomputed: the same bits as in K1
        q_s = (q * scale).contiguous()
        dq_s, dG, dpi = gate_expert_bwd(phi, xe, q_s, G, pi_det,
                                        g_res.contiguous(), ctx.thr,
                                        ctx.floor, denom=denom, bf16=ctx.bf16)
        # chain factor of the prescale, on the small (K, F) result (:446-447)
        return (None, None, dq_s * scale, dG, dpi, None, None, None, None)
