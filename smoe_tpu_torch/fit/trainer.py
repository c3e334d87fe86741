"""SMoE fitting in PyTorch: block-sweep training with multi-group Adam
(from smoe_tpu/fit/trainer.py).

One training step is one sweep over the pixel blocks: per block the
forward (through the fused gate+expert op: K1 forward, K2 backward on the
card) and its backward, with the gradients summed unweighted over the
blocks (trainer.py:538-541), then one Adam step for all parameter groups,
then the kernel lists become that sweep's influence-culling survivors
(trainer.py:666-671).  Each step's metrics describe the parameters before
its update (trainer.py:1248-1251).  `run_batched_chunk` runs n such steps
and pulls its metrics to the host once, at the end of the chunk.

The JAX package compiles a chunk into one XLA program (trainer.py:1-16).
Here a sweep reads and writes only tensors that live across sweeps (the
params and their gradients, Adam's state, one lists buffer, one metrics
row), so on the card a chunk captures one sweep as a CUDA graph and
replays it (fit/graph.py): one graph per cap bucket, keyed by every value
and tensor address it bakes in.  A mesh sweep is captured when its
collectives run on NCCL; on the CPU, under `eager()` and on a gloo mesh
(whose collectives run on the host) the same sweep runs eagerly.  The
evals and the LS refresh are programs of their own (`Programs`): eager at
a key's first call, captured at its second, replayed after.

Beside Adam, the fit can re-solve the experts in closed form
(`ls_init_experts`, `train(ls_refresh_iter=N)`; fit/lsinit.py), train on
the SSIM loss (`ssim_opt`), fake-quantize in the graph (QAT modes 2 and 3)
and insert kernels incrementally (`add_kernel_slots`, `reinit_inc`,
`train_inc`, `apply_inc`; fit/incremental.py), as the JAX package does.

Video (d = 3): `Smoe(vid, affines=...)` places a motion-compensated kernel
set on the t = -5 plane of the warped domain beside a disabled raw-domain
set (the dual model, video/init_strategies.py); every forward transforms
the pixels by the per-frame motion rows (video/motion.py) and the fused op
runs at the dual-domain width 2F = 26.  `train_trafo=True` trains the
motion rows (Adam group 5, frame 0 frozen) on the plain path, since the
fused op gives coords no gradient.  `reseed_time_slab` activates spare
raw-domain kernels where the error is.

Light fields (d = 4) train through the same sweep on the blocked corner-
view mask (fit/blocks.py), a weight under `lf_corner_weight > 0`.

`train_svs=True` adds the support-vector residual (`sv_residual`): one
RBF coefficient and steering factor per pixel, block-local rows or, under
`sv_shared_grid`, one row per image pixel gathered by every block that
covers it (`_RowGather`, a backward without float atomics).
`sampling_percentage < 100` trains each block on a Gumbel top-k draw of
its pixels in proportion to the last reconstruction's error
(`gumbel_topk`), the uniforms from the trainer's own torch.Generator.

`mesh=` (a `DeviceMesh` with the dimensions ("b",) or ("b", "k"), one
process per card; parallel/sharded.py:make_mesh) runs the same fit over
several processes (trainer.py:948-1102).  Each 'b' rank sweeps its share
of the blocks through `_block_loss` (K1/K2 on the card), then one psum over
'b' carries the flattened gradients, the loss, the mse and the sweep's
survivors as a zero-filled (B, K) slab; every rank then steps Adam on the
same gradients and reads the same lists, so its host decisions (the capped
width, the divergence guard, the best snapshots) agree.  A 'k' dimension
of size nk > 1 also splits the kernel rows: each rank holds K/nk rows, their
gradients and both optimizers' moments, the forward takes the plain path
with the gating denominator and the expert sums psum'd over 'k'
(core/model.py), and the rows are gathered where the whole model is read
(evals, list refreshes, `get_params`, checkpoints, the LS solve).
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smoe_tpu_torch.config import OptConfig, SmoeConfig
from smoe_tpu_torch.core import losses as L
from smoe_tpu_torch.core.init import get_batch_shape, init_params
from smoe_tpu_torch.core.model import (ForwardOut, _aat, _exact_matmul,
                                       clip_unit, expert_regression,
                                       fake_quant_unit, forward_fused,
                                       gating, kernel_quadratics,
                                       maha_from_A, quadratic_features,
                                       resolve_fused)
from smoe_tpu_torch.core.params import (SmoeParams, adam_state_from_numpy,
                                        assemble_A, params_from_numpy)
from smoe_tpu_torch.core.quant import apply_qat
from smoe_tpu_torch.core.ssim import ssim_loss
from smoe_tpu_torch.diag.profile import PhaseTimer, span
from smoe_tpu_torch.fit.blocks import (_block_view, build_blockset,
                                       initialize_kernel_lists, probe_points,
                                       row_chunks, stitch_blocks,
                                       update_kernel_lists)
from smoe_tpu_torch.fit.graph import (Programs, SweepGraph, graphed,
                                      tensor_key, warm_up)
# trainer.eager(): the chunk's eager witness on the card
from smoe_tpu_torch.fit.graph import eager  # noqa: F401
from smoe_tpu_torch.parallel.compat import (all_sum_, gather_rows,
                                            group_of, psum, rank_range,
                                            size_rank)
from smoe_tpu_torch.video.motion import transform_coords

# the per-kernel fields of SmoeParams; a video fit also holds `motion`, an
# SV fit the per-pixel SV_FIELDS (`Smoe._fields`)
PARAM_FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")
SV_FIELDS = ("sv", "sv_bw_diag", "sv_bw_corr")
_MOTION_ROWS = ("h11", "h12", "h13", "h21", "h22", "h23", "h31", "h32")
SV_COUNT_THRESHOLD = 5e-3     # num_sv and the eval's threshold (smoe.py:1536)


class RegWeights(NamedTuple):
    pis_l1: float
    u_l1: float
    sv_l1_sub_l2: float


class EffParams(NamedTuple):
    """Assembled, fake-quantized parameters as consumed by the forward pass
    (the q* tensors + assembled A of reference smoe.py:473-753)."""
    A: torch.Tensor
    musX: torch.Tensor
    nu_e: torch.Tensor
    gamma_e: torch.Tensor
    pis: torch.Tensor
    motion: Optional[torch.Tensor]


def effective_params(params: SmoeParams, cfg: SmoeConfig,
                     musX_grid: Optional[torch.Tensor],
                     kernel_group=None) -> EffParams:
    """trainer.py:82-89.  kernel_group: the rows are split over 'k' (the
    QAT-3 bounds go global)."""
    eff = apply_qat(params, cfg, kernel_group)
    musX = eff.musX + musX_grid if (cfg.use_diff_center and musX_grid
                                    is not None) else eff.musX
    return EffParams(A=assemble_A(eff, cfg), musX=musX, nu_e=eff.nu_e,
                     gamma_e=eff.gamma_e, pis=eff.pis, motion=eff.motion)


def sv_residual(coords: torch.Tensor, sv_rows: torch.Tensor,
                bw_diag: torch.Tensor, bw_corr: torch.Tensor, thr_sv: float):
    """Support-vector residual on a block (trainer.py:92-124, reference
    smoe.py:688-709): every pixel a owns an RBF with its own steering factor
    A_a,
        res_sv[b] = sum_a exp(-(x_b - x_a)^T A_a A_a^T (x_b - x_a)) SV_a,
    SVs below thr_sv zeroed, through the quadratic-feature product with
    B' = 2 A A^T (exp(-m) = exp(-0.5 m')) in exact fp32, the maha clamped
    at 0.  Forms an (Nb, Nb) map.  Returns (res_sv (Nb,), sv_eff (Nb, 1))."""
    d = coords.shape[1]
    eye = torch.eye(d, dtype=bw_diag.dtype, device=bw_diag.device)
    diag = torch.diagonal(bw_diag, dim1=1, dim2=2)
    A_sv = diag[:, :, None] * eye[None] + torch.tril(bw_corr, diagonal=-1)
    q_sv = kernel_quadratics(2.0 * _aat(A_sv), coords)
    maha = _exact_matmul(quadratic_features(coords), q_sv.T)
    maha = torch.maximum(maha, maha.new_zeros(()))
    kmat = torch.exp(-0.5 * maha)
    sv_eff = sv_rows * (torch.abs(sv_rows) >= thr_sv)
    return _exact_matmul(kmat, sv_eff)[:, 0], sv_eff


class _RowGather(torch.autograd.Function):
    """src (n, ...), idx (m,) int64 -> src[idx], for the shared-grid SV
    rows (trainer.py:457-467): the real rows of a block's window are
    distinct, and every image-edge pad position gathers the dummy row
    n - 1.  The backward writes each real row's gradient with one copy and
    sums the dummy row's in a fixed order, where index_add_ would add with
    float atomics on the card, so two runs from one state give the same
    bits."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, m = ctx.n, idx.shape[0]
        # each pad position to a scratch row of its own: every target is
        # distinct, so index_copy_ involves no accumulation
        spare = torch.arange(n, n + m, device=idx.device)
        out = g.new_zeros((n + m,) + g.shape[1:])
        out.index_copy_(0, torch.where(idx < n - 1, idx, spare), g)
        grad = out[:n]
        grad[n - 1] = out[n:].sum(0)
        return grad, None


def gumbel_topk(probs: torch.Tensor, uniform: torch.Tensor, sample_n: int,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The error-proportional draw without replacement of one block's
    pixels (trainer.py:476-486; np.random.choice(p=...) of reference
    smoe.py:1664-1667) as a Gumbel top-k on the given uniforms in
    [1e-20, 1): scores = log(max(probs, 1e-20)) - log(-log(u)), masked to
    -inf outside `valid` (bool, or a float weight > 0).  Returns the
    sample_n indices in descending score order, equal scores lower index
    first, as lax.top_k gives them."""
    g = -torch.log(-torch.log(uniform))
    scores = torch.log(torch.clamp(probs, min=1e-20)) + g
    if valid is not None:
        keep = valid if valid.dtype == torch.bool else valid > 0
        scores = torch.where(keep, scores,
                             scores.new_full((), float("-inf")))
    order = torch.sort(scores, descending=True, stable=True).indices
    return order[:sample_n]


def _forward_eff(eff: EffParams, cfg: SmoeConfig, coords: torch.Tensor,
                 kernel_mask: torch.Tensor, fused: bool = False,
                 sv_add: Optional[torch.Tensor] = None,
                 k_cap: Optional[int] = None,
                 model_mask: Optional[torch.Tensor] = None,
                 kernel_group=None) -> ForwardOut:
    """Forward from the effective view (trainer.py:127-179).  fused: take
    the fused op (capped to k_cap) where the config allows it: not under
    train_inverse_cov, and not while the motion rows train (the fused op
    gives coords no gradient).  kernel_group: this rank holds some of the
    kernel rows; the plain path psums the denominator and the expert sums
    over 'k' (the fused op normalises inside K1 and cannot, trainer.py:
    369-374), and the survivors are this rank's.

    A video model (eff.motion) gates and regresses on the motion-
    transformed pixels; with a model mask (its presence is the dual-model
    signal: a reloaded pickle carries the mask, not necessarily
    cfg.dual_model) the mask's False kernels gate on the raw pixels."""
    coords_raw = None
    if eff.motion is not None and cfg.dim_domain == 3:
        if model_mask is not None:
            coords_raw = coords
        coords = transform_coords(coords, eff.motion, cfg.num_params_model,
                                  cfg.num_frames)
    if fused and kernel_group is None and not cfg.train_inverse_cov and not (
            eff.motion is not None and cfg.train_trafo):
        return forward_fused(eff.A, eff.musX, eff.nu_e, eff.gamma_e,
                             eff.pis, cfg, coords, kernel_mask,
                             sv_add=sv_add, k_cap=k_cap,
                             coords_raw=coords_raw, model_mask=model_mask)
    maha = maha_from_A(eff.A, eff.musX, cfg, coords, coords_raw, model_mask)
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    w_e = gating(maha, eff.pis, diag_A, cfg, kernel_mask, kernel_group)
    res = expert_regression(w_e, coords, eff.nu_e, eff.gamma_e, cfg,
                            kernel_group)
    if sv_add is not None:
        res = torch.cat([res[:, :1] + sv_add[:, None], res[:, 1:]], dim=1)
    res = fake_quant_unit(clip_unit(res), cfg.precision)
    survivors = torch.any(w_e > cfg.minimum_influence, dim=0)
    return ForwardOut(res=res, w_e=w_e, survivors=survivors, maha=maha)


def _with_reg(loss_pix: torch.Tensor, eff: EffParams, cfg: SmoeConfig,
              kernel_mask: torch.Tensor, reg: RegWeights, kernel_group=None):
    """loss_pix + pis L1 + bandwidth L1 over the block's active kernels,
    in the JAX op order (trainer.py:231-243, 787-795); under kernel_group
    the live count and both sums go through one psum over 'k'.
    Returns (loss, num_active)."""
    active = kernel_mask & (eff.pis > 0)
    num_active = torch.sum(eff.pis > 0)
    s_pis = torch.sum(torch.where(active, eff.pis,
                                  torch.zeros_like(eff.pis)))
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    s_diag = torch.sum(torch.where(active[:, None], diag_A,
                                   torch.zeros_like(diag_A)))
    if kernel_group is not None:
        tot = psum(torch.stack([num_active.to(s_pis.dtype), s_pis, s_diag]),
                   kernel_group)
        num_active, s_pis, s_diag = tot[0].round().long(), tot[1], tot[2]
    norm = (num_active.to(torch.float32) if cfg.kernel_count_as_norm_l1
            else float(cfg.start_pis))
    return loss_pix + reg.pis_l1 * s_pis / norm + reg.u_l1 * s_diag, \
        num_active


def _pixel_term(res: torch.Tensor, targets: torch.Tensor, cfg: SmoeConfig,
                loss_w: Optional[torch.Tensor], valid: Optional[torch.Tensor],
                block_padded: Tuple[int, ...]):
    """(the block's data term, its LossAux): the eps-insensitive loss, or
    under ssim_opt 1 - SSIM of the block reshaped to its padded shape with
    the overlap cropped, beside the mse of pixel_loss without loss weights
    (trainer.py:213-229, 774-786)."""
    if not cfg.ssim_opt:
        la = L.pixel_loss(res, targets, cfg, loss_w, valid)
        return la.loss_pixel, la
    c = targets.shape[-1]
    res_img = res.reshape(tuple(block_padded) + (c,))
    tgt_img = targets.reshape(tuple(block_padded) + (c,))
    ov = cfg.overlap
    if ov > 0:
        sl = tuple(slice(ov, n - ov) for n in block_padded)
        res_img, tgt_img = res_img[sl], tgt_img[sl]
    loss_pix = ssim_loss(res_img, tgt_img, cfg.use_yuv, ndim=cfg.dim_domain)
    return loss_pix, L.pixel_loss(res, targets, cfg, None, valid)


def _block_loss(params: SmoeParams, cfg: SmoeConfig, coords: torch.Tensor,
                targets: torch.Tensor, kernel_mask: torch.Tensor,
                valid: Optional[torch.Tensor],
                loss_w: Optional[torch.Tensor], reg: RegWeights,
                musX_grid: Optional[torch.Tensor],
                block_padded: Tuple[int, ...], fused: bool = False,
                k_cap: Optional[int] = None,
                model_mask: Optional[torch.Tensor] = None,
                sv_blk=None, thr_sv: float = 0.0, kernel_group=None):
    """Loss of one block, differentiable in the raw params (trainer.py:
    186-250).  sv_blk: this block's (sv, bw_diag, bw_corr) rows, whose
    residual joins the Y channel before the clip and whose L1 - L2 penalty
    is normalised by the rows fed.  kernel_group: `params`, `kernel_mask`,
    `musX_grid` and `model_mask` hold this rank's kernel rows of a 'k'
    split; the QAT-3 bounds, the denominator, the expert sums and the
    regularizers are psum'd over the group (trainer.py:186-250).
    Returns (loss, (mse, survivors, err_map, num_active))."""
    eff = effective_params(params, cfg, musX_grid, kernel_group)
    sv_add = sv_eff = None
    if sv_blk is not None:
        sv_add, sv_eff = sv_residual(coords, *sv_blk, thr_sv)
    out = _forward_eff(eff, cfg, coords, kernel_mask, fused=fused,
                       sv_add=sv_add, k_cap=k_cap, model_mask=model_mask,
                       kernel_group=kernel_group)
    loss_pix, la = _pixel_term(out.res, targets, cfg, loss_w, valid,
                               block_padded)
    loss, num_active = _with_reg(loss_pix, eff, cfg, kernel_mask, reg,
                                 kernel_group)
    if sv_eff is not None:
        loss = loss + L.sv_l1_sub_l2_reg(sv_eff, reg.sv_l1_sub_l2,
                                         int(sv_eff.shape[0]))
    return loss, (la.mse, out.survivors, la.err_map, num_active)


def _optimizer_key(opt) -> Optional[tuple]:
    """What a captured step bakes in of an optimizer: its groups'
    hyperparameters and the tensors of its state."""
    if opt is None:
        return None
    return tuple(
        (tuple((k, v) for k, v in sorted(g.items()) if k != "params"),
         tuple((tensor_key(p), tuple((k, tensor_key(v)) for k, v in
                                     sorted(opt.state.get(p, {}).items())))
               for p in g["params"]))
        for g in opt.param_groups)


def make_optimizer(params: SmoeParams, cfg: SmoeConfig,
                   opt_cfg: OptConfig, inc: bool = False) -> torch.optim.Adam:
    """One torch.optim.Adam over the reference's learning-rate groups,
    counterpart of `make_tx` (trainer.py:253-286): {nu_e, gamma_e, musX}
    at base_lr, pis at base_lr / lr_div, A (a_diag, a_corr) at
    base_lr * lr_mult, under train_svs the SV rows at base_lr *
    lr_mult_sv, and under train_trafo the video motion rows at base_lr
    (those two in the main optimizer only: the inc one gives them zero
    gradients, which move no Adam state that starts at zero).  A group
    optax sets to zero (disabled or lr 0) is left out, so its tensors never
    move.  The
    gradient clip (`grad_clip_value_abs`) is applied by the trainer before
    each step."""
    oc = opt_cfg
    groups = []
    for name, fields, lr, enabled in (
            ("nu", ("nu_e",), oc.base_lr, True),
            ("gamma", ("gamma_e",), oc.base_lr, cfg.train_gammas),
            ("musx", ("musX",), oc.base_lr, cfg.train_musx),
            ("pis", ("pis",), oc.base_lr / oc.lr_div, cfg.train_pis),
            ("A", ("a_diag", "a_corr"), oc.base_lr * oc.lr_mult, True),
            ("sv", SV_FIELDS, oc.base_lr * oc.lr_mult_sv,
             cfg.train_svs and not inc and params.sv is not None),
            ("motion", ("motion",), oc.base_lr,
             cfg.train_trafo and not inc and params.motion is not None)):
        if enabled and lr != 0:
            groups.append({"params": [getattr(params, f) for f in fields],
                           "lr": lr, "name": name, "fields": fields})
    # optax.adam's defaults; eps sits outside the sqrt in both.  On the
    # card the step count and bias corrections live on the device
    # (capturable), as optax's count does, so a CUDA graph replays the step
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8,
                            capturable=params.pis.device.type == "cuda")


def fit_mesh_to_blocks(mesh, num_blocks: int):
    """The mesh, where its 'b' dimension divides the block count
    (trainer.py:289-317).  JAX shrinks the 'b' axis to a dividing device
    subset when no process is orphaned; here every rank is a process of its
    own, so any shrink would orphan one, and the count must divide."""
    nb, _ = size_rank(mesh, "b")
    B = int(num_blocks)
    if B % nb == 0:
        return mesh
    nb2 = max(d for d in range(1, min(nb, B) + 1) if B % d == 0)
    orphans = mesh.mesh.narrow(mesh.mesh_dim_names.index("b"), nb2, nb - nb2)
    raise ValueError(
        f"{B} blocks do not divide over the {nb}-way 'b' mesh axis, and "
        f"shrinking to {nb2} devices would orphan processes "
        f"{sorted(orphans.flatten().tolist())}; choose start_batches as a "
        f"multiple of the fleet size")


class Smoe:
    """SMoE model + fitting loop with the JAX `Smoe`'s API
    (trainer.py:934-1833, reference class Smoe, smoe.py:37)."""

    def __init__(self, image: np.ndarray,
                 kernels_per_dim=None,
                 init_params_dict: Optional[dict] = None,
                 start_batches: int = 1,
                 batch_size: Optional[Tuple[int, ...]] = None,
                 cfg: Optional[SmoeConfig] = None,
                 opt_cfg: Optional[OptConfig] = None,
                 loss_mask: Optional[np.ndarray] = None,
                 affines: Optional[np.ndarray] = None,
                 init_flag: float = 1,
                 iter_offset: int = 0,
                 mesh=None,
                 musX_grid_init: Optional[np.ndarray] = None,
                 model_mask_init: Optional[np.ndarray] = None,
                 device=None,
                 **cfg_overrides):
        """device: where the fit runs ("cuda", "cpu", a torch.device);
        defaults to "cuda" and raises when no card is present (pass
        device="cpu" to fit on the CPU).

        mesh: a DeviceMesh (`parallel.sharded.make_mesh`) over this run's
        processes, one a card, with a 'b' dimension and optionally a 'k'
        one, its device type the device's (trainer.py:948-967).  'b' splits
        the blocks, whose count must divide over it; 'k' of size nk > 1
        splits the kernel capacity, which must divide over it, and takes the
        plain path.  Every rank must make the same calls in the same order:
        each holds the whole blocked image and the (B, K) kernel lists."""
        image = np.asarray(image, np.float32)
        dim = image.ndim - 1
        if cfg is None:
            kpd = tuple(kernels_per_dim) if kernels_per_dim else (12,) * dim
            if len(kpd) == 1:
                kpd = kpd * dim
            cfg = SmoeConfig(dim_domain=dim, num_channels=image.shape[-1],
                             kernels_per_dim=kpd, **cfg_overrides)
        if image.shape[-1] != 3 and cfg.use_yuv:
            cfg = cfg.replace(use_yuv=False)
        if cfg.dim_domain == 3 and cfg.train_trafo and cfg.num_frames == 0:
            cfg = cfg.replace(num_frames=image.shape[2])

        # motion-compensated video init (trainer.py:981-1010): warp the
        # domain by the per-frame affines, place the model-0 kernels by
        # init_flag, concatenate the disabled raw-domain model-1 kernels
        motion_init = None
        if model_mask_init is not None:   # reload path (container pickle)
            model_mask_init = np.asarray(model_mask_init, bool)
            cfg = cfg.replace(dual_model=True)
        self.num_2d_kernels = None
        if cfg.dim_domain == 3 and affines is not None \
                and init_params_dict is None:
            from smoe_tpu_torch.core.init import (generate_experts,
                                                  generate_kernel_grid,
                                                  generate_pis)
            from smoe_tpu_torch.video.init_strategies import (
                dual_model_concat, motion_from_affines, video_kernel_init,
                warp_domain)
            affines = np.asarray(affines, np.float32)
            cfg = cfg.replace(num_frames=image.shape[2], dual_model=True)
            warped = warp_domain(image, affines, cfg.num_params_model)
            m0 = video_kernel_init(image, warped, cfg.kernels_per_dim,
                                   init_flag)
            base = cfg.replace(dual_model=False, start_pis_override=0)
            musX1, A1 = generate_kernel_grid(base)
            nu1, g1 = generate_experts(image, musX1, base)
            m1 = {"musX": musX1, "A": A1, "nu_e": nu1, "gamma_e": g1,
                  "pis": generate_pis(musX1.shape[0], cfg.normalize_pis)}
            init_params_dict, model_mask_init = dual_model_concat(m0, m1)
            cfg = cfg.replace(
                start_pis_override=int(init_params_dict["pis"].shape[0]))
            motion_init = motion_from_affines(affines, image.shape)
            self.num_2d_kernels = int(np.sum(init_params_dict["pis"] > 0))
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Smoe: device {str(self.device)!r}: no CUDA device is "
                "available (pass device=\"cpu\" to fit on the CPU)")
        self.fused = resolve_fused(cfg.use_pallas, self.device)

        # block shape (reference smoe.py:231-247, 2459-2543)
        if batch_size is not None:
            bs = tuple(batch_size)
            if len(bs) == 1:
                bs = bs * dim
        else:
            joint_shape = image.shape[:dim] + (dim + image.shape[-1],)
            bs = get_batch_shape(start_batches, joint_shape)[:dim]
        cfg = cfg.replace(block_shape=tuple(int(b) for b in bs))
        if init_params_dict is not None:
            rows = int(np.asarray(init_params_dict["pis"]).shape[0])
            if rows > cfg.capacity:
                cfg = cfg.replace(start_pis_override=rows,
                                  add_kernel_slots=0)

        self.cfg = cfg
        self.image = image
        self.num_pixel = int(np.prod(image.shape[:dim]))
        self.opt_cfg = opt_cfg or OptConfig()
        self.musX_grid = None
        if cfg.use_diff_center and musX_grid_init is not None:
            # reload path: the saved musX are the learned diffs; the
            # container carries the matching grid rows (trainer.py:1041-1051)
            g = np.zeros((cfg.capacity, cfg.dim_domain), np.float32)
            rows = np.asarray(musX_grid_init, np.float32)
            g[:rows.shape[0]] = rows
            self.musX_grid = torch.as_tensor(g, device=self.device)
        if motion_init is None and init_params_dict is not None \
                and "h11" in init_params_dict and cfg.dim_domain == 3:
            # reload path: the per-frame motion rows get_params saved
            motion_init = np.stack([np.asarray(init_params_dict[r],
                                               np.float32)
                                    for r in _MOTION_ROWS])
            if cfg.num_frames == 0:
                cfg = cfg.replace(num_frames=motion_init.shape[1])
                self.cfg = cfg
        self._set_mesh(mesh)
        self._init_params(init_params_dict, motion_init=motion_init)
        self.model_mask = None     # dual model: kernel -> domain (True: t)
        if model_mask_init is not None:
            pad_n = cfg.capacity - model_mask_init.shape[0]
            self.model_mask = torch.as_tensor(np.concatenate(
                [model_mask_init, np.ones((pad_n,), bool)]),
                device=self.device)

        self.bset = build_blockset(image, cfg, cfg.block_shape,
                                   device=self.device)
        self.start_batches = int(self.bset.coords.shape[0])
        if mesh is not None:
            fit_mesh_to_blocks(mesh, self.start_batches)
        nb, rb = size_rank(mesh, "b")
        self._blocks = rank_range(self.start_batches, nb, rb) \
            if mesh is not None else slice(0, self.start_batches)
        self.block_weight = float(np.prod(self.bset.block_valued)) \
            / self.num_pixel
        self.loss_mask = None
        if loss_mask is not None:
            # blocked with the same overlap as coords/targets
            lm = loss_mask.reshape(loss_mask.shape[:dim] + (1,))
            self.loss_mask = torch.as_tensor(
                _block_view(lm.astype(np.float32), cfg.block_shape,
                            cfg.overlap)[..., 0], device=self.device)
        self.optimizer: Optional[torch.optim.Adam] = None
        # the captured sweeps (graph key -> SweepGraph) and their pool; the
        # sweep's (B, K) lists buffer and metrics row (`_sweep_buffers`)
        self._graphs: Dict[tuple, SweepGraph] = {}
        self._graph_pool = None
        self._sweep_bufs = None
        # the evals' and the LS refresh's programs (fit/graph.py), captured
        # into the same pool; the quantized eval's params, scattered into
        # full-capacity buffers (`_load_rparams`)
        self._programs = Programs()
        self._qeff: Optional[Tuple[torch.Tensor, ...]] = None
        self._init_kernel_lists()

        # histories (reference smoe.py:183-194)
        self.losses, self.qlosses = [], []
        self.mses, self.qmses = [], []
        self.losses_history, self.mses_history = [], []
        self.num_pis, self.num_svs = [], []
        self.best_loss = None
        self.best_mse = None
        self.best_qloss = None
        self.best_qmse = None
        self.best_params: Optional[Dict[str, np.ndarray]] = None
        # global best across train() phases (trainer.py:1131-1139)
        self.global_best_loss = None
        self.global_best_mse = None
        self.global_best_params: Optional[Dict[str, np.ndarray]] = None
        self.valid = False
        self.qvalid = False
        self.reconstruction_image = None
        self.qreconstruction_image = None
        self.weight_matrix_argmax = None
        self.qweight_matrix_argmax = None
        self.qparams = None
        self.rparams = None
        self.iter = int(iter_offset)
        self.kernel_count = cfg.start_pis
        self.num_inc_kernels = cfg.start_pis if cfg.add_kernel_slots else 0
        # the main rows; the last num_inc_kernels rows are the inc block,
        # trained by the inc optimizer (trainer.py:388-396)
        main = torch.ones((cfg.capacity,), dtype=torch.bool,
                          device=self.device)
        if self.num_inc_kernels:
            main[cfg.capacity - self.num_inc_kernels:] = False
        self._main_rows = self._local(main)
        self.inc_optimizer: Optional[torch.optim.Adam] = None
        self.phase_timer = PhaseTimer()
        # error-proportional sampling: per-block probabilities (uniform
        # until an eval with the reconstruction, trainer.py:1117-1119,
        # 1405) and the draw's own generator, seeded as JAX's PRNGKey(0)
        nb = int(np.prod(self.bset.block_padded))
        self.sampling_probs = torch.full((self.start_batches, nb), 1.0 / nb,
                                         device=self.device)
        self.reconstruction_sv = None
        self._reseed_generator()

    # ---------------- the mesh ----------------

    def _set_mesh(self, mesh) -> None:
        """The 'b' and 'k' groups and this rank's kernel rows."""
        self.mesh = mesh
        self._bgroup = group_of(mesh, "b")
        self._kgroup = None
        self._krows = slice(0, self.cfg.capacity)
        self._rows_depth = 0          # > 0 inside _all_rows
        if mesh is None:
            return
        if "b" not in (mesh.mesh_dim_names or ()):
            raise ValueError("Smoe(mesh=): the mesh needs a 'b' dimension "
                             f"(it has {mesh.mesh_dim_names})")
        if torch.device(mesh.device_type).type != self.device.type:
            raise ValueError(f"Smoe(mesh=): a {mesh.device_type!r} mesh for "
                             f"a fit on {str(self.device)!r}")
        nk, rk = size_rank(mesh, "k")
        if nk > 1:
            if self.cfg.capacity % nk:
                raise ValueError(
                    f"kernel capacity {self.cfg.capacity} does not divide "
                    f"over the {nk}-way 'k' mesh axis")
            self._kgroup = group_of(mesh, "k")
            self._krows = rank_range(self.cfg.capacity, nk, rk)
            # K1 normalises inside the kernel and cannot psum mid-kernel
            self.fused = False

    def _split(self) -> bool:
        """Whether self.params holds only this rank's kernel rows."""
        return self._kgroup is not None and not self._rows_depth

    def _local(self, t):
        """This rank's rows of a whole (capacity, ...) tensor."""
        return t if t is None or not self._split() else t[self._krows]

    def _gather_rows(self, t: torch.Tensor, field: str):
        """The whole (capacity, ...) tensor of a kernel field from every
        rank's rows (detached)."""
        t = t.detach()
        if not self._split() or field not in PARAM_FIELDS:
            return t
        return gather_rows(t, self._krows, self.cfg.capacity, self._kgroup)

    def _full_params(self) -> SmoeParams:
        """The raw params with every kernel row: self.params, or under a
        'k' split the rows gathered in one all-reduce (no gradient)."""
        if not self._split():
            return self.params
        p = self.params
        flat = torch.cat([getattr(p, f).detach().reshape(
            p.pis.shape[0], -1) for f in PARAM_FIELDS], dim=1)
        flat = gather_rows(flat, self._krows, self.cfg.capacity,
                           self._kgroup)
        out, i = {}, 0
        for f in PARAM_FIELDS:
            t = getattr(p, f)
            w = int(np.prod(t.shape[1:]))
            out[f] = flat[:, i:i + w].reshape((-1,) + tuple(t.shape[1:]))
            i += w
        return dataclasses.replace(p, **out)

    @contextlib.contextmanager
    def _all_rows(self):
        """Under a 'k' split: self.params holds every kernel row for the
        body (the LS solve, the inc rows, the reseed, the gating map), and
        what it writes to them goes back to this rank's rows after."""
        if not self._split():        # no 'k' split, or inside already
            yield
            return
        local, self.params = self.params, self._full_params()
        self._rows_depth += 1
        try:
            yield
        finally:
            self._rows_depth -= 1
            full, self.params = self.params, local
            with torch.no_grad():
                for f in PARAM_FIELDS:
                    getattr(local, f).copy_(getattr(full, f)[self._krows])

    def _gather_blocks(self, flat_parts, block_parts):
        """One all-reduce over 'b': `flat_parts` (tensors summed whole) and
        `block_parts` ((n_own, ...) rows of this rank's blocks, returned as
        (B, ...) with every rank's rows).  Returns (flat_parts, block
        parts) reduced."""
        B = self.start_batches
        slabs = []
        for t in block_parts:
            slab = t.new_zeros((B,) + tuple(t.shape[1:]), dtype=torch.float32)
            slab[self._blocks] = t.to(torch.float32)
            slabs.append(slab)
        parts = list(flat_parts) + slabs
        buf = all_sum_(torch.cat([t.reshape(-1).to(torch.float32)
                                  for t in parts]), self._bgroup)
        out, i = [], 0
        for t in parts:
            out.append(buf[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out[:len(flat_parts)], out[len(flat_parts):]

    # ---------------- parameters ----------------

    def _init_params(self, init: Optional[dict] = None,
                     zero_diff: bool = False,
                     motion_init: Optional[np.ndarray] = None) -> None:
        """Fresh leaf tensors from `init_params` (trainer.py:1038-1070).
        Under use_diff_center the first call takes the grid from the init
        and trains offsets from zero; zero_diff (reinit) zeroes them
        against the grid already held.  A video fit also holds the (8, T)
        motion rows: `motion_init`, else the identity `init_params` gives;
        they are a leaf that trains only under train_trafo."""
        p = init_params(self.image, self.cfg, init)
        vals = {f: torch.as_tensor(np.array(getattr(p, f), np.float32),
                                   device=self.device) for f in PARAM_FIELDS}
        motion = p.motion if motion_init is None else motion_init
        self._fields = PARAM_FIELDS
        if p.sv is not None:
            for f in SV_FIELDS:
                vals[f] = torch.as_tensor(np.array(getattr(p, f), np.float32),
                                          device=self.device)
            self._fields = PARAM_FIELDS + SV_FIELDS
        if motion is not None:
            vals["motion"] = torch.as_tensor(np.array(motion, np.float32),
                                             device=self.device)
            self._fields = self._fields + ("motion",)
        if self.cfg.use_diff_center and (self.musX_grid is None
                                         or zero_diff):
            if self.musX_grid is None:
                self.musX_grid = vals["musX"]
            vals["musX"] = torch.zeros_like(vals["musX"])
        for f in PARAM_FIELDS:       # this rank's rows of a 'k' split
            vals[f] = self._local(vals[f]).clone()
        for f, t in vals.items():
            t.requires_grad_(f != "motion" or self.cfg.train_trafo)
        self.params = SmoeParams(**vals)
        self._masked_grads = None     # _step's inc split, per params

    def set_params(self, params) -> None:
        """Overwrite the raw parameters in place (the optimizer keeps its
        state).  params: a `SmoeParams`, or a dict keyed by field names or
        by the `get_params()` names, as `params_from_numpy` takes them."""
        new = params_from_numpy(params, device=self.device)
        with torch.no_grad():
            for f in self._fields:
                v = getattr(new, f, None)
                if v is not None:
                    getattr(self.params, f).copy_(
                        self._local(v) if f in PARAM_FIELDS else v)
        self.valid = self.qvalid = False

    def _init_kernel_lists(self) -> None:
        cfg = self.cfg
        if self.model_mask is not None or (cfg.dim_domain == 3
                                           and cfg.train_trafo):
            # motion-compensated video starts with all-on lists (reference
            # smoe.py:314-317): a raw-domain center assignment would be
            # wrong for kernels on the t = -5 motion plane
            self.kernel_lists = torch.ones(
                (int(self.bset.coords.shape[0]), cfg.capacity),
                dtype=torch.bool, device=self.device)
            return
        with torch.no_grad():
            eff0 = effective_params(self._full_params(), cfg, self.musX_grid)
            self.kernel_lists = initialize_kernel_lists(
                eff0.A, eff0.musX, eff0.pis, cfg, self.bset)

    # ---------------- optimizer ----------------

    def set_optimizer(self, opt_cfg: Optional[OptConfig] = None, **kw):
        """(Re)build the main and the inc optimizer with fresh state
        (trainer.py:1159-1169)."""
        if opt_cfg is None:
            opt_cfg = dataclasses.replace(self.opt_cfg, **kw) if kw \
                else self.opt_cfg
        self.opt_cfg = opt_cfg
        self.optimizer = make_optimizer(self.params, self.cfg, opt_cfg)
        self.inc_optimizer = make_optimizer(self.params, self.cfg, opt_cfg,
                                            inc=True)

    def set_inc_optimizer(self, reset: bool = False):
        """The inc rows' optimizer: the main rig's learning-rate groups with
        state of its own (trainer.py:1171-1175, reference smoe_test.py:
        93-97); reset=True starts it afresh (apply_inc)."""
        if self.inc_optimizer is None or reset:
            self.inc_optimizer = make_optimizer(self.params, self.cfg,
                                                self.opt_cfg, inc=True)

    def adam_state_numpy(self, optimizer=None) -> Optional[dict]:
        """An optimizer's moments as numpy (the main one by default):
        {"count", "mu": {field: array}, "nu": {field: array}}, the form
        `adam_state_from_numpy` takes; under a 'k' split every rank calls
        it (the kernel rows are gathered)."""
        opt = self.optimizer if optimizer is None else optimizer
        if opt is None:
            return None
        mu, nu, count = {}, {}, 0
        for g in opt.param_groups:
            for f, p in zip(g["fields"], g["params"]):
                st = opt.state.get(p)
                if st:
                    mu[f] = self._gather_rows(st["exp_avg"], f).cpu().numpy()
                    nu[f] = self._gather_rows(st["exp_avg_sq"],
                                              f).cpu().numpy()
                    count = int(st["step"])
        return {"count": count, "mu": mu, "nu": nu}

    def load_adam_state(self, state: Dict[str, dict], inc: bool = False
                        ) -> None:
        """Install per-field Adam state (from `adam_state_from_numpy`) for
        the tensors the main (or, with inc=True, the inc) optimizer holds."""
        if self.optimizer is None:
            self.set_optimizer()
        opt = self.inc_optimizer if inc else self.optimizer
        for g in opt.param_groups:
            for f, p in zip(g["fields"], g["params"]):
                if f not in state:
                    continue
                new = {k: (self._local(v) if f in PARAM_FIELDS
                           else v).to(p.device) if k != "step"
                       # capturable Adam counts on the device
                       else v.to(p.device) if g["capturable"] else v
                       for k, v in state[f].items()}
                old = opt.state.get(p, {})
                if old.keys() == new.keys() and all(
                        old[k].shape == v.shape and old[k].device == v.device
                        for k, v in new.items()):
                    # in place: a captured sweep keeps reading them
                    with torch.no_grad():
                        for k, v in new.items():
                            old[k].copy_(v)
                else:
                    opt.state[p] = new

    def load_state_numpy(self, params, model_mask=None, musX_grid=None,
                         kernel_lists=None, num_2d_kernels=None,
                         adam=None) -> None:
        """Install a whole trainer state given as numpy, so that two
        trainers (this package's, or the JAX package's `Smoe` through
        `np.asarray` of its fields) continue from one state: the raw params
        (a `SmoeParams` of arrays or a dict, with the motion rows as
        `motion` or h11..h32), the dual model's mask (padded with True to
        the capacity), the diff-center grid, the kernel lists, the count of
        motion-plane kernels the reseeding starts after, and Adam's
        moments as (mu, nu, count) with their motion leaf
        (`adam_state_from_numpy`)."""
        self.set_params(params)
        if model_mask is not None:
            mm = np.ones((self.cfg.capacity,), bool)
            mm[:len(model_mask)] = np.asarray(model_mask, bool)
            self.model_mask = torch.as_tensor(mm, device=self.device)
        if musX_grid is not None:
            self.musX_grid = torch.as_tensor(
                np.array(musX_grid, np.float32), device=self.device)
        if kernel_lists is not None:
            self.kernel_lists = torch.as_tensor(
                np.array(kernel_lists, bool), device=self.device)
        if num_2d_kernels is not None:
            self.num_2d_kernels = int(num_2d_kernels)
        if adam is not None:
            mu, nu, count = adam
            self.load_adam_state(adam_state_from_numpy(
                mu, nu, count, device=self.device))

    # ---------------- kernel lists and the capped width ----------------

    @property
    def kernel_lists(self):
        return self._kernel_lists

    @kernel_lists.setter
    def kernel_lists(self, v):
        # lists assigned from outside the sweep may grow, so the capped-
        # dense width must be re-derived; sweep-internal survivor feedback
        # only shrinks and writes _kernel_lists directly (trainer.py:1187-95)
        self._kernel_lists = v
        self._k_cap_cache = None

    def _cap_bucket(self, count: int) -> Optional[int]:
        """128-lane bucket for a kernel count; None = full width
        (trainer.py:1234-1238, kept so lists and survivors match JAX)."""
        cap = max(128, -(-count // 128) * 128)
        k_pad = -(-self.cfg.capacity // 128) * 128
        return cap if cap < k_pad else None

    def _current_k_cap(self) -> Optional[int]:
        """Width cap for the capped-dense mode: the largest per-block list
        count in its 128 bucket, cached until the lists can grow
        (trainer.py:1197-1228).  Sound for a whole chunk: within it the
        lists only shrink."""
        if not self.fused:       # the capped width applies to the fused op
            return None
        if self._k_cap_cache is None:
            pad = 0
            if self.cfg.in_graph_ukl:
                # rebuild the lists as exactly the probe-near & active set
                self.update_kernel_list(replace=True)
                pad = 128
            count = int(self._kernel_lists.sum(dim=1).max()) \
                if self.start_batches else 0
            self._k_cap_cache = (self._cap_bucket(count + pad),)
        return self._k_cap_cache[0]

    # ---------------- sweeps ----------------

    def _valid(self, b: int) -> Optional[torch.Tensor]:
        """Block b's pixel mask: the overlap crop and the LF view mask."""
        valid = self.bset.valid if self.cfg.overlap > 0 else None
        tm = self.bset.train_mask
        if tm is not None:
            tm = tm[b]
            if tm.dtype == torch.bool:
                valid = tm if valid is None else valid & tm
            else:
                valid = tm if valid is None else tm * valid
        return valid

    def _reseed_generator(self) -> None:
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    def _sample_uniform(self, n: int) -> torch.Tensor:
        """n uniforms in [1e-20, 1) from the trainer's generator, on the
        device (jax.random.uniform(minval=1e-20), trainer.py:480-481)."""
        u = torch.rand((n,), generator=self._gen, device=self.device)
        return torch.clamp(u, min=1e-20)

    def _sample_n(self, sampling_percentage) -> Optional[int]:
        """Pixels a block trains on under subsampling, or None: the JAX
        sweep samples only below 100 % and neither under the SSIM loss nor
        under overlap (trainer.py:440-442)."""
        if sampling_percentage >= 100 or self.cfg.ssim_opt \
                or self.cfg.overlap > 0:
            return None
        return int(round(np.prod(self.bset.block_padded)
                         * sampling_percentage / 100.0))

    def _sv_block(self, b: int):
        """Block b's (sv, bw_diag, bw_corr) rows (trainer.py:456-475): a
        slice of the block-local rows, or the shared grid's rows gathered
        by the block's window, the dummy row's SV zeroed."""
        p = self.params
        idx = self.bset.sv_index
        if idx is not None:
            svix = idx[b]
            real = (svix < p.sv.shape[0] - 1)[:, None]
            return (_RowGather.apply(p.sv, svix) * real,
                    _RowGather.apply(p.sv_bw_diag, svix),
                    _RowGather.apply(p.sv_bw_corr, svix))
        nb = self.bset.coords.shape[1]
        sl = slice(b * nb, (b + 1) * nb)
        return p.sv[sl], p.sv_bw_diag[sl], p.sv_bw_corr[sl]

    def _block_inputs(self, b: int, loss_w, sample_n: Optional[int]):
        """(coords, targets, loss weights, valid, SV rows) of block b as a
        training sweep feeds them (trainer.py:446-501); under subsampling
        the drawn pixels, SV rows riding the same indices, with no valid
        mask left."""
        coords, targets = self.bset.coords[b], self.bset.targets[b]
        lw = None if loss_w is None else loss_w[b]
        valid = self._valid(b)
        sv_blk = self._sv_block(b) if self.cfg.train_svs else None
        if sample_n is not None:
            idx = gumbel_topk(self.sampling_probs[b],
                              self._sample_uniform(coords.shape[0]),
                              sample_n, valid)
            coords, targets = coords[idx], targets[idx]
            lw = None if lw is None else lw[idx]
            valid = None
            if sv_blk is not None:
                sv_blk = tuple(a[idx] for a in sv_blk)
        return coords, targets, lw, valid, sv_blk

    def _sweep_grads(self, lists, reg: RegWeights, loss_w, k_cap,
                     sample_n: Optional[int] = None, thr_sv: float = 0.0):
        """Forward + backward over every block; the gradients are summed
        unweighted into .grad, zero-filled first so that every tensor the
        optimizer holds takes its step (optax updates a leaf from momentum
        alone; torch.optim.Adam skips a tensor whose grad is None).

        Under a mesh only this rank's blocks are swept (every block's
        uniforms are still drawn, so the draw does not depend on the mesh),
        then one psum over 'b' carries the gradients, loss, mse and the
        survivors (trainer.py:546-551); under a 'k' split a second one over
        'k' carries the survivors' columns, the motion gradient (motion acts
        before the split maha, trainer.py:553-559) and the live count.
        Returns (loss, mse, survivors (B, K), num_pi) on the device, num_pi
        counting the live pis before the update."""
        for p in self._trained():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        with torch.no_grad():
            num_pi = torch.sum(apply_qat(self.params, self.cfg).pis > 0)
        bw = self.block_weight
        zero = torch.zeros((), device=self.device)
        loss_acc, mse_acc = zero, zero
        survivors = []
        kg = self._kgroup
        grid, mmask = self._local(self.musX_grid), self._local(self.model_mask)
        for b in range(self.start_batches):
            if not self._blocks.start <= b < self._blocks.stop:
                if sample_n is not None:
                    self._sample_uniform(self.bset.coords.shape[1])
                continue
            coords, targets, lw, valid, sv_blk = self._block_inputs(
                b, loss_w, sample_n)
            loss, (mse, surv, _, _) = _block_loss(
                self.params, self.cfg, coords, targets, self._local(lists[b]),
                valid, lw, reg, grid, self.bset.block_padded,
                fused=self.fused, k_cap=k_cap, model_mask=mmask,
                sv_blk=sv_blk, thr_sv=thr_sv, kernel_group=kg)
            loss.backward()
            loss_acc = loss_acc + bw * loss.detach()
            mse_acc = mse_acc + bw * mse.detach()
            survivors.append(surv)
        survivors = torch.stack(survivors)
        if self.mesh is None:
            return loss_acc, mse_acc, survivors, num_pi
        trained = self._trained()
        if kg is not None:         # this rank's columns of the (B, K) lists
            cols = survivors.new_zeros((survivors.shape[0],
                                        self.cfg.capacity))
            cols[:, self._krows] = survivors
            survivors = cols
        (*grads, loss_acc, mse_acc), (survivors,) = self._gather_blocks(
            [p.grad for p in trained] + [loss_acc, mse_acc], [survivors])
        for p, g in zip(trained, grads):
            p.grad.copy_(g)
        if kg is not None:
            motion = self.params.motion if self.cfg.train_trafo else None
            parts = [survivors.reshape(-1), num_pi.reshape(1).float()]
            if motion is not None:
                parts.append(motion.grad.reshape(-1))
            buf = all_sum_(torch.cat(parts), kg)
            n = survivors.numel()
            survivors = buf[:n].reshape(survivors.shape)
            num_pi = buf[n].round().long()
            if motion is not None:
                motion.grad.copy_(buf[n + 1:].reshape(motion.shape))
        return loss_acc, mse_acc, survivors > 0.5, num_pi

    def _step(self, train_orig: bool = True, train_inc: bool = False) -> None:
        """One Adam step of the main optimizer on the main rows' gradients
        and, with train_inc, one of the inc optimizer on the inc rows'
        (trainer.py:602-617); without inc slots every row is a main row.
        Each optimizer reads its rows' gradients from buffers that live as
        long as the params, and .grad is the summed gradient again after."""
        clip = self.opt_cfg.grad_clip_value_abs
        params = [getattr(self.params, f) for f in PARAM_FIELDS]
        if clip is not None:
            # optax.clip: elementwise, before the Adam transform
            for p in self._trained():
                p.grad.clamp_(-clip, clip)
        if self.cfg.train_trafo and self.params.motion is not None:
            # frame 0 needs no transform: its column never moves
            # (trainer.py:605-608, reference smoe.py:1155-1158).  The motion
            # rows belong to the main optimizer alone, whole.
            self.params.motion.grad[:, 0] = 0.0
        if not self.num_inc_kernels and not train_inc:
            if train_orig:
                self.optimizer.step()
            return
        grads = [p.grad for p in params]
        if self._masked_grads is None:
            self._masked_grads = [torch.empty_like(g) for g in grads]
        for opt, rows, on in ((self.optimizer, self._main_rows, train_orig),
                              (self.inc_optimizer, ~self._main_rows,
                               train_inc)):
            if not on:
                continue
            for p, g, m in zip(params, grads, self._masked_grads):
                p.grad = torch.mul(
                    g, rows.reshape((-1,) + (1,) * (g.ndim - 1)), out=m)
            opt.step()
        for p, g in zip(params, grads):
            p.grad = g

    def _trained(self):
        """The leaf tensors that take gradients: the per-kernel fields and,
        under train_trafo, the motion rows."""
        return [p for p in (getattr(self.params, f) for f in self._fields)
                if p.requires_grad]

    def _probe_args(self, eff: EffParams) -> dict:
        """update_kernel_lists' probe arguments: for motion-compensated
        video the probe boxes are recomputed on the blocks' transformed
        extent from the current motion rows (trainer.py:1449-1457, reference
        smoe.py:2292-2317), and the dual model's raw-domain kernels are
        probed against the raw boxes."""
        if eff.motion is None or self.cfg.dim_domain != 3:
            return {}
        B, Nb, d = self.bset.coords.shape
        tc = transform_coords(self.bset.coords.reshape(-1, d), eff.motion,
                              self.cfg.num_params_model,
                              self.cfg.num_frames).reshape(B, Nb, d)
        probes = probe_points(tc.amin(dim=1), tc.amax(dim=1),
                              grid=getattr(self.cfg, "probe_grid", 3))
        if self.model_mask is None:
            return {"probes": probes}
        return {"probes": probes, "probes_raw": self.bset.probes,
                "model_mask": self.model_mask}

    def _sweep_buffers(self):
        """The sweep's (B, K) lists buffer and its (5,) metrics row,
        allocated once: a captured sweep reads and writes them in place."""
        if self._sweep_bufs is None:
            self._sweep_bufs = (
                torch.zeros_like(self._kernel_lists, dtype=torch.bool),
                torch.zeros((5,), device=self.device))
        return self._sweep_bufs

    def _sweep(self, lists, row, reg: RegWeights, loss_w, k_cap, sample_n,
               thr_sv: float, train_orig: bool, train_inc: bool,
               refresh: bool) -> None:
        """One training sweep (trainer.py:602-671) on the lists in `lists`:
        the gradients, the Adam step(s), then the next lists (the
        survivors, | probe-near under `refresh`) written into `lists` and
        (loss, mse, num_pi, num_sv, the largest list count) into `row`,
        both in place.  The metrics describe the params before the update."""
        loss, mse, survivors, num_pi = self._sweep_grads(
            lists, reg, loss_w, k_cap, sample_n, thr_sv)
        with torch.no_grad():
            num_sv = self._num_sv()
            if train_orig or train_inc:
                self._step(train_orig, train_inc)
            new = survivors
            if refresh:
                # survivors | probe-near under the updated params
                # (trainer.py:631-654)
                eff = effective_params(self._full_params(), self.cfg,
                                       self.musX_grid)
                new = update_kernel_lists(eff.A, eff.musX, eff.pis,
                                          self.cfg, self.bset, new,
                                          **self._probe_args(eff))
            kmax = torch.max(torch.sum(new, dim=1))
            row.copy_(torch.stack([loss, mse, num_pi.float(),
                                   num_sv.float(), kmax.float()]))
            lists.copy_(new)

    def _graph_key(self, args) -> tuple:
        """Everything a captured `_sweep(*args)` bakes in: the Python values
        it branched on or took as constants, and the address and layout of
        every tensor it reads or writes."""
        lists, row, reg, loss_w, k_cap, sample_n, thr_sv, train_orig, \
            train_inc, refresh = args
        t = tensor_key
        fields = tuple((f, t(v), v.requires_grad, t(v.grad)) for f, v in (
            (f, getattr(self.params, f)) for f in self._fields))
        return (self.cfg, self.fused, self.opt_cfg.grad_clip_value_abs,
                k_cap, sample_n, thr_sv, train_orig, train_inc, refresh, reg,
                self.block_weight, self.num_inc_kernels, fields,
                _optimizer_key(self.optimizer),
                _optimizer_key(self.inc_optimizer),
                tuple(t(m) for m in self._masked_grads or ()),
                t(lists), t(row), t(loss_w), t(self.musX_grid),
                t(self.model_mask), t(self._main_rows),
                t(self.sampling_probs) if sample_n is not None else None,
                tuple(t(v) if torch.is_tensor(v) else v for v in self.bset),
                self._gen, self._mesh_key())

    def _pool(self):
        """The graph pool the trainer's graphs share: each capture reuses
        what the earlier ones freed (`fit/graph.py:side_stream`)."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _new_graph(self, fn) -> SweepGraph:
        """fn captured into the pool the trainer's graphs share, with the
        subsampling generator registered."""
        return SweepGraph(fn, self._pool(), generators=(self._gen,))

    def _mesh_key(self):
        """What a captured mesh sweep bakes in of the mesh: this rank's
        blocks and rows, each group and its backend (None without a
        mesh)."""
        if self.mesh is None:
            return None
        import torch.distributed as dist
        return ((self._blocks.start, self._blocks.stop, self._krows.start,
                 self._krows.stop),
                tuple((g, dist.get_backend(g)) for g in (self._bgroup,
                                                         self._kgroup)
                      if g is not None))

    def _sweep_captured(self) -> bool:
        """Whether the chunk's sweeps replay a graph: on the card outside
        `eager()`, in one process or on a mesh whose collectives all run
        on NCCL, which a graph captures.  A gloo mesh sweeps eagerly: its
        collectives run on the host, and the backend decides it, not an
        error."""
        mk = self._mesh_key()
        return graphed(self.device) and (
            mk is None or all(b == "nccl" for _, b in mk[1]))

    def _program(self, key: tuple, fn):
        """fn()'s outputs: on the card in one process, outside `eager()`,
        from the trainer's program of `key` (fit/graph.py:Programs: the
        first call eager, the second captured, later ones replayed; the
        outputs in buffers the next call overwrites); else fn() itself.
        Under a mesh the evals and the LS refresh stay eager."""
        if self.mesh is None and graphed(self.device):
            self._programs.pool = self._pool()
            return self._programs.run(key, fn)
        return fn()

    def _state_key(self) -> tuple:
        """What an eval or an LS program bakes in of the trainer: the
        values its forward branches on and the address and layout of every
        tensor of the model and the blocks it reads."""
        t = tensor_key
        return (self.cfg, self.fused, self.block_weight,
                tuple((f, t(getattr(self.params, f))) for f in self._fields),
                t(self.musX_grid), t(self.model_mask),
                tuple(t(v) if torch.is_tensor(v) else v for v in self.bset))

    def run_batched_chunk(self, n_steps, pis_l1=0.0, u_l1=0.0,
                          sv_l1_sub_l2=0.0, sampling_percentage=100,
                          train_orig=True, train_inc=False, thr_sv=None,
                          use_loss_mask=False):
        """`n_steps` training sweeps with one host pull at the end
        (trainer.py:1240-1294).  Returns per-step numpy arrays (loss, mse,
        num_pi, num_sv); each step's metrics describe the params before
        that step's update.  The SVs train at thr_sv (None: 0, as the
        reference trains, smoe.py:1552).

        On the card (one process or an NCCL mesh, outside `eager()`) the
        sweeps after the first replay one captured graph: a chunk whose key
        has no graph runs its first sweep eagerly as the warm-up, then
        captures one.  A gloo mesh sweeps eagerly (`_sweep_captured`)."""
        with span("smoe.fit.chunk"):
            if self.optimizer is None:
                self.set_optimizer()
            reg = RegWeights(float(pis_l1), float(u_l1), float(sv_l1_sub_l2))
            lw = self.loss_mask if use_loss_mask else None
            tsv = 0.0 if thr_sv is None else float(thr_sv)
            sample_n = self._sample_n(sampling_percentage)
            k_cap = self._current_k_cap()
            # the in-graph refresh does not run while the inc rows train:
            # their pis are 0 until apply_inc, so a refresh would drop them
            # from every list and cut their gradients
            refresh = bool(self.cfg.in_graph_ukl and not train_inc)
            lists, row = self._sweep_buffers()
            lists.copy_(self._kernel_lists)
            args = (lists, row, reg, lw, k_cap, sample_n, tsv,
                    bool(train_orig), bool(train_inc), refresh)

            def sweep():
                self._sweep(*args)

            n = int(n_steps)
            ys = torch.empty((n, 5), device=self.device)
            done, graph = 0, None
            if n and self._sweep_captured():
                graph = self._graphs.get(self._graph_key(args))
                if graph is None:
                    warm_up(sweep)
                    ys[0].copy_(row)
                    done = 1
                    # keyed after the warm-up, which made Adam's state
                    graph = self._graphs[self._graph_key(args)] = \
                        self._new_graph(sweep)
            for i in range(done, n):
                if graph is None:
                    sweep()
                else:
                    graph.replay()
                ys[i].copy_(row)
            # survivor feedback only shrinks the lists: keep the cached cap
            self._kernel_lists = lists.clone()
            self.valid = False
            ys = ys.cpu().numpy()                      # the one host pull
            loss_a, mse_a = ys[:, 0], ys[:, 1]
            npi_a, nsv_a = ys[:, 2].astype(np.int32), ys[:, 3].astype(np.int32)
            kmax_last = int(ys[-1, 4]) if len(ys) else 0
            # adapt the capped width from the list count that rode along
            # (trainer.py:1284-1293)
            if self.fused and len(ys):
                cur = self._k_cap_cache[0]
                if self.cfg.in_graph_ukl:
                    self._k_cap_cache = (self._cap_bucket(kmax_last + 128),)
                else:
                    new = self._cap_bucket(kmax_last)
                    if new is not None and (cur is None or new < cur):
                        self._k_cap_cache = (new,)
            return loss_a, mse_a, npi_a, nsv_a

    def _time_s(self, fn) -> float:
        """Seconds of fn(): CUDA events on the card, the host clock on the
        CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize(self.device)
            return t0.elapsed_time(t1) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def phase_breakdown(self, n_steps: int = 50) -> Dict[str, float]:
        """Per-phase step time in seconds/iteration at the current capped
        width (trainer.py:1296-1339): fwd (forward + loss of every block,
        the graph built and dropped), bwd (forward + backward with the
        gradients accumulated, minus fwd), opt_metrics (the production
        sweep minus both) and step.  On the card each piece is a sweep
        captured as `run_batched_chunk` captures its sweep (JAX jits
        fwd_multi / fwdbwd_multi, trainer.py:915-927), so the pieces time
        the path that trains.  Like the JAX version, `step` trains the
        model 2 * n_steps iterations as a side effect.  One process only,
        as in JAX (trainer.py:856)."""
        if self.mesh is not None:
            raise ValueError("phase_breakdown is a one-device diagnostic")
        if self.optimizer is None:
            self.set_optimizer()
        kcap = self._current_k_cap()
        reg = RegWeights(0.0, 0.0, 0.0)
        lists, _ = self._sweep_buffers()
        lists.copy_(self._kernel_lists)

        def fwd():
            for b in range(self.start_batches):
                coords, targets, _, valid, sv_blk = self._block_inputs(
                    b, None, None)
                _block_loss(self.params, self.cfg, coords, targets,
                            lists[b], valid, None, reg, self.musX_grid,
                            self.bset.block_padded, fused=self.fused,
                            k_cap=kcap, model_mask=self.model_mask,
                            sv_blk=sv_blk)

        def fwd_bwd():
            self._sweep_grads(lists, reg, None, kcap)

        pieces = [fwd, fwd_bwd]
        if graphed(self.device):
            for i, fn in enumerate(pieces):
                warm_up(fn)
                pieces[i] = self._new_graph(fn).replay

        def repeat(fn):
            return lambda: [fn() for _ in range(n_steps)]

        repeat(pieces[1])()                       # warm-up
        t_fwd = self._time_s(repeat(pieces[0])) / n_steps
        t_fb = self._time_s(repeat(pieces[1])) / n_steps
        self.run_batched_chunk(n_steps)           # warm at this cap
        t_step = self._time_s(lambda: self.run_batched_chunk(n_steps)) \
            / n_steps
        return {"fwd": t_fwd, "bwd": t_fb - t_fwd,
                "opt_metrics": t_step - t_fb, "step": t_step,
                "k_cap": float(kcap) if kcap is not None
                else float(self.cfg.capacity)}

    def _num_sv(self) -> torch.Tensor:
        """The count of SVs above 5e-3 in magnitude (trainer.py:619), 0
        without SVs."""
        if self.params.sv is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return torch.sum(torch.abs(self.params.sv) > SV_COUNT_THRESHOLD)

    @torch.no_grad()
    def _eval_sweep(self, eff: EffParams, klists, loss_w, reg: RegWeights,
                    with_rec: bool, exact: bool, thr_sv: float):
        """Eval sweep (trainer.py:685-836).  with_rec or exact: the plain
        path, row-chunked, with the reconstruction and the gating argmax;
        otherwise the light validation
        through the fused op at full width.  Quantized-param evals (exact)
        must match the decoder, so they never take the fused op.  The SV
        residual (float SVs at thr_sv) joins every eval, with its penalty
        normalised by the block's pixels.  with_rec also returns each
        block's sampling probabilities and SV map.  Under a mesh each rank
        evaluates its blocks with the whole `eff` and one psum over 'b'
        sums the loss and mse and gathers the per-block outputs; a mesh
        eval stays eager (`_program`), its gather (`_gather_blocks`) on
        gloo as on NCCL."""
        cfg = self.cfg
        bw = self.block_weight
        plain = with_rec or exact
        nb = int(np.prod(self.bset.block_padded))
        loss_acc = torch.zeros((), device=self.device)
        mse_acc = torch.zeros((), device=self.device)
        res_l, wam_l, surv_l, prob_l, sv_l = [], [], [], [], []
        for b in range(self._blocks.start, self._blocks.stop):
            coords, kmask = self.bset.coords[b], klists[b]
            sv_add = sv_eff = None
            if cfg.train_svs and self.params.sv is not None:
                sv_add, sv_eff = sv_residual(coords, *self._sv_block(b),
                                             thr_sv)
            if plain:
                s = row_chunks(coords.shape[0], int(cfg.capacity))
                m = coords.shape[0] // s
                outs = [_forward_eff(eff, cfg, coords[i * m:(i + 1) * m],
                                     kmask, model_mask=self.model_mask,
                                     sv_add=None if sv_add is None
                                     else sv_add[i * m:(i + 1) * m])
                        for i in range(s)]
                res = torch.cat([o.res for o in outs])
                surv = torch.stack([o.survivors for o in outs]).any(dim=0)
                if with_rec:
                    wam_l.append(torch.cat([torch.argmax(o.w_e, dim=1)
                                            for o in outs]))
            else:
                out = _forward_eff(eff, cfg, coords, kmask, fused=self.fused,
                                   model_mask=self.model_mask, sv_add=sv_add)
                res, surv = out.res, out.survivors
            loss_pix, la = _pixel_term(
                res, self.bset.targets[b], cfg,
                None if loss_w is None else loss_w[b], self._valid(b),
                self.bset.block_padded)
            loss, _ = _with_reg(loss_pix, eff, cfg, kmask, reg)
            if sv_eff is not None:
                loss = loss + L.sv_l1_sub_l2_reg(sv_eff, reg.sv_l1_sub_l2,
                                                 nb)
            loss_acc = loss_acc + bw * loss
            mse_acc = mse_acc + bw * la.mse
            surv_l.append(surv)
            if with_rec:
                res_l.append(res)
                prob_l.append(la.err_map / torch.clamp(
                    torch.sum(la.err_map), min=1e-30))
                if sv_add is not None:
                    sv_l.append(sv_add)
        num_pi = torch.sum(eff.pis > 0)
        outs = [torch.stack(surv_l)]
        if with_rec:
            outs += [torch.stack(res_l), torch.stack(wam_l),
                     torch.stack(prob_l)] + ([torch.stack(sv_l)] if sv_l
                                             else [])
        if self.mesh is not None:
            (loss_acc, mse_acc), outs = self._gather_blocks(
                [loss_acc, mse_acc], outs)
            outs[0] = outs[0] > 0.5
            if with_rec:
                outs[2] = outs[2].long()
        rec = None
        if with_rec:
            rec = (outs[1], outs[2], outs[3],
                   outs[4] if len(outs) > 4 else None)
        return loss_acc, mse_acc, outs[0], num_pi, rec

    def run_batched(self, pis_l1=0.0, u_l1=0.0, sv_l1_sub_l2=0.0, train=True,
                    update_reconstruction=False, with_quantized_params=False,
                    sampling_percentage=100, with_inc=False, train_inc=False,
                    thr_sv=None, use_loss_mask=False):
        """One sweep over all blocks (trainer.py:1341-1418): a training
        sweep, or an evaluation (light, with the reconstruction, or with
        the quantized params).  Returns (loss, mse, num_pi, num_sv)."""
        if (train or train_inc) and not with_quantized_params:
            loss, mse, npi, nsv = self.run_batched_chunk(
                1, pis_l1, u_l1, sv_l1_sub_l2, sampling_percentage,
                train_orig=train, train_inc=train_inc, thr_sv=thr_sv,
                use_loss_mask=use_loss_mask)
            return float(loss[-1]), float(mse[-1]), int(npi[-1]), int(nsv[-1])

        with span("smoe.fit.eval"):
            reg = RegWeights(float(pis_l1), float(u_l1), float(sv_l1_sub_l2))
            lw = self.loss_mask if use_loss_mask else None
            with_rec, exact = bool(update_reconstruction), \
                bool(with_quantized_params)
            # the SVs evaluate at the reporting threshold (smoe.py:1536, 1558)
            tsv = SV_COUNT_THRESHOLD if thr_sv is None else float(thr_sv)
            if exact:
                self._load_rparams()
            # the lists in the sweep's own buffer, which every chunk refills
            lists, _ = self._sweep_buffers()
            lists.copy_(self.kernel_lists)
            t = tensor_key
            key = ("eval", with_rec, exact, tsv, reg, t(lists), t(lw),
                   tuple(t(b) for b in self._qeff) if exact else None,
                   self._state_key())
            h, surv, *rec = self._program(key, lambda: self._eval_program(
                lists, lw, reg, with_rec, exact, tsv))
            h = h.cpu().numpy()                        # the one host pull
            if update_reconstruction:
                res, wam, probs = rec[:3]
                sv_map = rec[3] if len(rec) > 3 else None
                # in place: a captured subsampled sweep reads this tensor
                self.sampling_probs.copy_(probs)
                if sv_map is not None:
                    self.reconstruction_sv = stitch_blocks(
                        sv_map[..., None], self.bset)[..., 0].cpu().numpy()
                image = stitch_blocks(res, self.bset).cpu().numpy()
                wam = stitch_blocks(wam[..., None], self.bset)[..., 0] \
                    .cpu().numpy()
                if with_quantized_params:
                    self.qreconstruction_image = image
                    self.qweight_matrix_argmax = wam
                    self.qvalid = True
                else:
                    self.reconstruction_image = image
                    self.weight_matrix_argmax = wam
                    self.valid = True
            if not with_quantized_params:
                self._update_kernel_lists_from(surv.clone())
            return float(h[0]), float(h[1]), int(h[2]), int(h[3])

    @torch.no_grad()
    def _eval_program(self, lists, lw, reg: RegWeights, with_rec: bool,
                      exact: bool, thr_sv: float) -> tuple:
        """One eval as a program (`run_batched`; trainer.py:685-836 jits
        it): the params made effective (or the quantized ones read from
        their buffers), the lists (dense over the active kernels under
        in_graph_ukl, trainer.py:1375-1382), the sweep.  Returns (loss,
        mse, num_pi, num_sv) stacked, the survivors and, with_rec, the
        reconstruction, gating argmax, sampling probabilities and the SV
        map where there is one."""
        eff = self._qeff_params() if exact else effective_params(
            self._full_params(), self.cfg, self.musX_grid)
        kl = lists
        if self.cfg.in_graph_ukl:
            kl = (eff.pis > 0)[None, :].expand(kl.shape)
        loss, mse, surv, num_pi, rec = self._eval_sweep(
            eff, kl, lw, reg, with_rec=with_rec, exact=exact,
            thr_sv=thr_sv)
        h = torch.stack([loss, mse, num_pi.float(), self._num_sv().float()])
        return (h, surv) + tuple(x for x in rec or () if x is not None)

    def _update_kernel_lists_from(self, survivors):
        """Lists <- eval survivors (trainer.py:1420-1432): shrink-only, so
        the cached cap stays, except under in_graph_ukl whose eval ran
        dense."""
        if self.cfg.in_graph_ukl:
            self.kernel_lists = survivors
        else:
            self._kernel_lists = survivors

    @torch.no_grad()
    def update_kernel_list(self, *_, replace: bool = False):
        """Probe block corners/edges and OR into the lists (trainer.py:
        1434-1463, reference smoe.py:2287-2365); replace=True makes the
        lists exactly the probe-near & active set."""
        with span("smoe.fit.update_kernel_list"):
            eff = effective_params(self._full_params(), self.cfg,
                                   self.musX_grid)
            base = torch.zeros_like(self._kernel_lists) if replace \
                else self.kernel_lists
            self.kernel_lists = update_kernel_lists(
                eff.A, eff.musX, eff.pis, self.cfg, self.bset, base,
                **self._probe_args(eff))

    def _load_rparams(self) -> None:
        """Scatter the dequantized params back into full-capacity slots
        (dead slots pis=0) for the exact eval (trainer.py:1465-1492), into
        buffers that live as long as the trainer, with copy_: every
        quantized eval reads the same addresses, so its program replays on
        the card and reads the model of the call."""
        assert self.rparams is not None, "call quantize first"
        rp = self.rparams
        used = np.asarray(self.qparams["used_kernels"]) if self.qparams \
            else np.ones((rp["pis"].shape[0],), bool)
        cap = self.cfg.capacity
        d, c = self.cfg.dim_domain, self.image.shape[-1]
        A = np.zeros((cap, d, d), np.float32)
        musX = np.zeros((cap, d), np.float32)
        nu = np.zeros((cap, c), np.float32)
        gam = np.zeros((cap, d, c), np.float32)
        pis = np.zeros((cap,), np.float32)
        idx = np.where(used)[0] if used.shape[0] == cap \
            else np.arange(rp["pis"].shape[0])
        A[idx] = rp["A"]
        musX[idx] = rp["musX"]
        nu[idx] = rp["nu_e"]
        gam[idx] = rp["gamma_e"]
        pis[idx] = rp["pis"]
        host = (A, musX, nu, gam, pis)
        if self._qeff is None:
            self._qeff = tuple(torch.empty(a.shape, device=self.device)
                               for a in host)
        for buf, a in zip(self._qeff, host):
            buf.copy_(torch.from_numpy(a))

    def _qeff_params(self) -> EffParams:
        """The quantized params of `_load_rparams`' buffers, with the
        motion rows as training fake-quantizes them."""
        with torch.no_grad():
            motion = apply_qat(self.params, self.cfg).motion
        return EffParams(*self._qeff, motion=motion)

    def _eff_from_rparams(self) -> EffParams:
        """The exact eval's params: `_load_rparams`, then `_qeff_params`."""
        self._load_rparams()
        return self._qeff_params()

    def ls_init_experts(self, mode: str = "auto", ridge: float = 1e-6,
                        damp: float = 0.0, timings: Optional[dict] = None):
        """Closed-form least-squares (re)fit of the expert surfaces under
        the current gating (trainer.py:1722-1731, fit/lsinit.py).  Returns
        the gated pixel mass."""
        from smoe_tpu_torch.fit.lsinit import ls_refresh_experts
        # whole on every rank, as JAX runs it outside the mesh
        # (lsinit.py:405-406)
        with span("smoe.fit.ls_refresh"), self._all_rows():
            return ls_refresh_experts(self, mode=mode, ridge=ridge,
                                      damp=damp, timings=timings)

    # ---------------- training loop ----------------

    def _quantize_now(self):
        from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
        grid = None if self.musX_grid is None \
            else self.musX_grid.cpu().numpy()
        self.qparams = quantize_params(self.get_params(), self.cfg,
                                       musX_grid=grid)
        if self.cfg.quantization_mode == 1:
            self.rparams = rescaler(
                self.qparams, self.cfg, None if grid is None else
                grid[np.asarray(self.qparams["used_kernels"])])

    def train(self, num_iter, val_iter=100, ukl_iter=None, pis_l1=0.0,
              u_l1=0.0, sv_l1_sub_l2=0.0, sampling_percentage=100,
              callbacks=(), with_inc=False, train_inc=False, train_orig=True,
              use_loss_mask=False, grad_clip_value_abs=None,
              ls_refresh_iter=None):
        """Outer fit loop (trainer.py:1496-1652, reference smoe.py:
        1485-1603): initial eval, chunks of sweeps up to each validation /
        kernel-list boundary, kernel-list refresh, divergence guard,
        best-loss snapshot, callbacks.  ls_refresh_iter: every N iterations
        re-solve the experts in closed form (mode "kernel", line-searched,
        so the blend mse cannot rise)."""
        with span("smoe.fit.train"):
            if ukl_iter is None:
                ukl_iter = val_iter
            if grad_clip_value_abs is not None and \
                    grad_clip_value_abs != self.opt_cfg.grad_clip_value_abs:
                # the reference rebuilds its optimizers with the clip (fresh
                # state, smoe.py:1491)
                self.set_optimizer(grad_clip_value_abs=grad_clip_value_abs)
            if self.optimizer is None:
                self.set_optimizer()
            # the reconstruction's error map refreshes the sampling
            # probabilities (trainer.py:1517-1521)
            upd_rec = bool(callbacks) or sampling_percentage < 100
            qm = self.cfg.quantization_mode

            if qm >= 1:
                self._quantize_now()
            if qm == 1:
                self.best_qloss, self.best_qmse, _, _ = self.run_batched(
                    pis_l1, u_l1, sv_l1_sub_l2, train=False,
                    update_reconstruction=upd_rec, with_quantized_params=True)
                self.qlosses.append((0, self.best_qloss))
                self.qmses.append((0, self.best_qmse))

            loss_val, mse_val, num_pi, num_sv = self.run_batched(
                pis_l1, u_l1, sv_l1_sub_l2, train=False,
                update_reconstruction=upd_rec, use_loss_mask=use_loss_mask)
            self.best_loss, self.best_mse = loss_val, mse_val
            self._snapshot_best()
            self.losses.append((self.iter, loss_val))
            self.mses.append((self.iter, mse_val))
            self.num_pis.append((self.iter, num_pi))
            self.num_svs.append((self.iter, num_sv))
            for cb in callbacks:
                cb(self)

            first_loss = self.losses[0][1] if self.losses else loss_val
            i = 0
            while i < num_iter:
                boundary = min(((i // val_iter) + 1) * val_iter,
                               ((i // ukl_iter) + 1) * ukl_iter, num_iter)
                if ls_refresh_iter:
                    boundary = min(boundary, ((i // ls_refresh_iter) + 1)
                                   * ls_refresh_iter)
                chunk = boundary - i
                try:
                    with self.phase_timer.phase("train_sweeps"):
                        loss_a, mse_a, npi_a, nsv_a = self.run_batched_chunk(
                            chunk, pis_l1, u_l1, sv_l1_sub_l2,
                            sampling_percentage, train_orig=train_orig,
                            train_inc=train_inc, use_loss_mask=use_loss_mask)
                    i = boundary
                    self.iter += chunk
                    loss_val, mse_val = float(loss_a[-1]), float(mse_a[-1])
                    num_pi, num_sv = int(npi_a[-1]), int(nsv_a[-1])
                    # always validate the final iterate too (trainer.py:1578)
                    validate = i % val_iter == 0 or i == num_iter
                    do_ukl = i % ukl_iter == 0

                    # divergence guard over every step of the chunk
                    # (reference smoe.py:1565-1570)
                    if np.any(np.isnan(loss_a)) or np.any(
                            loss_a + 1 > (first_loss + 100) * 10):
                        print("stop: divergence guard")
                        break

                    if do_ukl:
                        self.update_kernel_list()
                        if not validate:
                            loss_val, mse_val, num_pi, num_sv = \
                                self.run_batched(pis_l1, u_l1, train=False)

                    if ls_refresh_iter and i % ls_refresh_iter == 0:
                        # before the validation, so the snapshot sees the
                        # refreshed (non-regressing) experts
                        self.ls_init_experts(mode="kernel")
                        if not validate:
                            loss_val, mse_val, num_pi, num_sv = \
                                self.run_batched(pis_l1, u_l1, train=False,
                                                 use_loss_mask=use_loss_mask)

                    if validate:
                        if qm >= 1:
                            self._quantize_now()
                        if qm == 1:
                            qloss_val, qmse_val, _, _ = self.run_batched(
                                pis_l1, u_l1, sv_l1_sub_l2, train=False,
                                update_reconstruction=upd_rec,
                                with_quantized_params=True,
                                use_loss_mask=use_loss_mask)
                            self.qlosses.append((self.iter, qloss_val))
                            self.qmses.append((self.iter, qmse_val))
                        loss_val, mse_val, num_pi, num_sv = self.run_batched(
                            pis_l1, u_l1, train=False,
                            update_reconstruction=upd_rec,
                            use_loss_mask=use_loss_mask)

                    if np.isnan(loss_val):
                        print("stop: divergence guard")
                        break

                    if validate:
                        if self.best_loss is None or loss_val < self.best_loss:
                            self.best_loss = loss_val
                            self._snapshot_best(mse=mse_val)
                        self.losses.append((self.iter, loss_val))
                        if self.best_mse is None or mse_val < self.best_mse:
                            self.best_mse = mse_val
                        self.mses.append((self.iter, mse_val))
                        self.num_pis.append((self.iter, num_pi))
                        self.num_svs.append((self.iter, num_sv))
                        for cb in callbacks:
                            cb(self)
                except KeyboardInterrupt:
                    break

            self.losses_history.append(self.losses)
            self.mses_history.append(self.mses)
            print(f"end loss/mse: {loss_val} / {mse_val} @iter {i}")
            print(f"best loss/mse: {self.best_loss} / {self.best_mse}")

    # ---------------- params access ----------------

    def get_params(self) -> Dict[str, np.ndarray]:
        """Effective (fake-quantized) params as a numpy dict
        (trainer.py:1656-1678), in one device-to-host copy; under a 'k'
        split every rank calls it (the rows are gathered first)."""
        with torch.no_grad():
            eff = apply_qat(self._full_params(), self.cfg)
            dev = {"pis": eff.pis, "musX": eff.musX,
                   "A_diagonal": eff.a_diag, "A_corr": eff.a_corr,
                   "gamma_e": eff.gamma_e, "nu_e": eff.nu_e}
            if eff.motion is not None:
                dev["_motion"] = eff.motion
            flat = torch.cat([v.reshape(-1) for v in dev.values()]).cpu()
        out, i = {}, 0
        for name, v in dev.items():
            out[name] = flat[i:i + v.numel()].numpy().reshape(v.shape)
            i += v.numel()
        m = out.pop("_motion", None)
        if m is not None:
            for j, name in enumerate(_MOTION_ROWS):
                out[name] = m[j]
        return out

    def _snapshot_best(self, mse=None):
        """mse: the current validation's mse (trainer.py:1680-1690)."""
        self.best_params = self.get_params()
        if self.global_best_loss is None or (
                self.best_loss is not None
                and self.best_loss < self.global_best_loss):
            self.global_best_loss = self.best_loss
            self.global_best_mse = self.best_mse if mse is None else mse
            self.global_best_params = self.best_params

    def get_best_params(self) -> Dict[str, np.ndarray]:
        """Best-validation snapshot of the last train() call."""
        return self.best_params if self.best_params is not None \
            else self.get_params()

    def get_global_best_params(self) -> Dict[str, np.ndarray]:
        """Best snapshot across all train() calls."""
        return self.global_best_params if self.global_best_params \
            is not None else self.get_best_params()

    def get_reconstruction(self):
        if not self.valid:
            self.run_batched(train=False, update_reconstruction=True)
        return self.reconstruction_image

    def get_qreconstruction(self):
        if not self.qvalid:
            self.run_batched(train=False, update_reconstruction=True,
                             with_quantized_params=True)
        return self.qreconstruction_image

    def get_weight_matrix_argmax(self):
        if not self.valid:
            self.run_batched(train=False, update_reconstruction=True)
        return self.weight_matrix_argmax

    def get_original_image(self):
        return np.squeeze(self.image)

    # histories (reference smoe.py:1857-1885)
    def get_losses(self): return self.losses
    def get_qlosses(self): return self.qlosses
    def get_best_loss(self): return self.best_loss
    def get_losses_history(self): return self.losses_history
    def get_mses(self): return self.mses
    def get_qmses(self): return self.qmses
    def get_best_mse(self): return self.best_mse
    def get_mses_history(self): return self.mses_history
    def get_num_pis(self): return self.num_pis
    def get_num_svs(self): return self.num_svs
    def get_iter(self): return self.iter

    # ---------------- checkpoint / restore ----------------

    def checkpoint(self, path: str):
        """Full trainer-state save as pickled numpy and Python values
        (trainer.py:1764-1786); no torch object is pickled.  Under a mesh
        every rank calls it (the kernel rows and moments are gathered) and
        rank 0 writes."""
        from smoe_tpu_torch.parallel.multihost import primary
        full = self._full_params()
        state = {
            "params": {f: getattr(full, f).detach().cpu().numpy()
                       for f in self._fields},
            "opt_state": self.adam_state_numpy(),
            "inc_opt_state": self.adam_state_numpy(self.inc_optimizer),
            "iter": self.iter, "losses": self.losses, "mses": self.mses,
            "num_pis": self.num_pis, "best_loss": self.best_loss,
            "best_mse": self.best_mse, "best_params": self.best_params,
            "global_best_loss": self.global_best_loss,
            "global_best_mse": self.global_best_mse,
            "global_best_params": self.global_best_params,
            "kernel_lists": self.kernel_lists.cpu().numpy(),
            "kernel_count": self.kernel_count,
            "cfg": self.cfg,
        }
        if self.mesh is not None and not primary():
            return
        with open(path, "wb") as fd:
            pickle.dump(state, fd)
        print(f"Model saved in file: {path}")

    def restore(self, path: str):
        """Inverse of `checkpoint` (trainer.py:1788-1814); every rank of a
        mesh restores the same file, which resumes on a mesh of another
        size where the block count divides it."""
        with open(path, "rb") as fd:
            state = pickle.load(fd)
        self.set_params(state["params"])
        opt = state["opt_state"]
        if opt is not None:
            self.set_optimizer()
            self.load_adam_state(adam_state_from_numpy(
                opt["mu"], opt["nu"], opt["count"], device=self.device))
        inc = state.get("inc_opt_state")
        if inc is not None:
            self.load_adam_state(adam_state_from_numpy(
                inc["mu"], inc["nu"], inc["count"], device=self.device),
                inc=True)
        self.iter = state["iter"]
        self.losses = state["losses"]
        self.mses = state["mses"]
        self.num_pis = state["num_pis"]
        self.best_loss = state["best_loss"]
        self.best_mse = state["best_mse"]
        self.best_params = state["best_params"]
        self.global_best_loss = state.get("global_best_loss", self.best_loss)
        self.global_best_mse = state.get("global_best_mse", self.best_mse)
        self.global_best_params = state.get("global_best_params",
                                            self.best_params)
        self.kernel_lists = torch.as_tensor(state["kernel_lists"],
                                            device=self.device)
        self.kernel_count = state.get("kernel_count", self.kernel_count)
        self.valid = False
        print(f"Model restored from {path}")

    def reinit(self):
        """Fresh params, optimizer state and kernel lists, keeping the
        configuration, blocks and built kernels (trainer.py:1816-1835)."""
        self._init_params(zero_diff=True)
        self.set_optimizer()
        self._init_kernel_lists()
        self.valid = False
        self.qvalid = False
        self.iter = 0
        self.losses, self.mses, self.num_pis, self.num_svs = [], [], [], []
        self.best_loss = self.best_mse = self.best_params = None
        self._reseed_generator()

    @torch.no_grad()
    def re_normalize_pis(self):
        """pis /= the sum of the listed, active pis, after a restore
        (trainer.py:1837-1845, reference smoe.py:774-775)."""
        pis = self._full_params().pis
        mask = torch.any(self.kernel_lists, dim=0) & (pis > 0)
        total = torch.sum(torch.where(mask, pis, torch.zeros_like(pis)))
        self.params.pis.copy_(self.params.pis / torch.clamp(total, min=1e-30))

    # ---------------- incremental kernels ----------------

    @torch.no_grad()
    def get_weight_matrix(self) -> np.ndarray:
        """The full (K, *spatial) gating map on the plain path, computed on
        demand (trainer.py:1733-1744)."""
        eff = effective_params(self._full_params(), self.cfg, self.musX_grid)
        w = torch.stack([_forward_eff(eff, self.cfg, self.bset.coords[b],
                                      self.kernel_lists[b],
                                      model_mask=self.model_mask).w_e
                         for b in range(self.start_batches)])
        full = stitch_blocks(w, self.bset).cpu().numpy()
        return np.moveaxis(full, -1, 0)

    def reinit_nu_from_argmax(self, rows: Optional[np.ndarray] = None):
        """nu_k <- mean image value over kernel k's argmax-gating region,
        0.5 where a kernel never wins (trainer.py:1848-1871, reference
        smoe.py:320-329).  `rows`: restrict the update to these rows."""
        with self._all_rows():
            self._reinit_nu_from_argmax(rows)

    def _reinit_nu_from_argmax(self, rows):
        c = self.image.shape[-1]
        cap = self.params.capacity
        w = np.asarray(self.get_weight_matrix_argmax()).reshape(-1)
        w = w.astype(np.int64)
        imgf = self.image.reshape(-1, c).astype(np.float64)
        sums = np.zeros((cap, c))
        np.add.at(sums, w, imgf)
        counts = np.bincount(w, minlength=cap).astype(np.float64)
        means = np.divide(sums, counts[:, None], out=np.full((cap, c), 0.5),
                          where=counts[:, None] > 0)
        nu = self.params.nu_e.detach().cpu().numpy().copy()
        if rows is None:
            nu[:] = means
        else:
            nu[rows] = means[rows]
        with torch.no_grad():
            self.params.nu_e.copy_(torch.as_tensor(nu.astype(np.float32)))
        self.valid = False

    def reseed_time_slab(self, kk: int, rng=None):
        """Activate the kk-th time slab of spare (disabled) kernels at
        error-proportional random pixel positions and re-init their experts
        from the gating argmax (trainer.py:1871-1910; the video reseed loop
        of reference smoe_test.py:123-207).  The draw is numpy's, as in the
        JAX package, so a seed picks the same rows and positions in both.
        Returns the activated row indices."""
        with span("smoe.fit.reseed"), self._all_rows():
            return self._reseed_time_slab(kk, rng)

    def _reseed_time_slab(self, kk: int, rng):
        cfg = self.cfg
        if cfg.dim_domain != 3:
            raise ValueError("time-slab reseeding is a video feature")
        rng = np.random.default_rng(rng)
        k2d = int(np.prod(cfg.kernels_per_dim[:2]))
        shape = self.image.shape[:3]

        rec = self.get_reconstruction().reshape(self.image.shape)
        wts = [6 / 8, 1 / 8, 1 / 8] \
            if (cfg.use_yuv and self.image.shape[-1] == 3) else None
        diff = np.average(np.square(255.0 * (self.image - rec)), axis=-1,
                          weights=wts) ** 2
        p = diff.reshape(-1) / diff.sum()
        idx = rng.choice(p.size, p=p, size=k2d, replace=False)
        pos = np.unravel_index(idx, shape)
        mus3 = np.stack([pos[i] / max(shape[i] - 1, 1) for i in range(3)],
                        axis=1).astype(np.float32)

        pis = self.params.pis.detach().cpu().numpy().copy()
        if self.num_2d_kernels is None or kk == 0:
            self.num_2d_kernels = int(np.sum(pis != 0))
        lo = self.num_2d_kernels + kk * k2d
        hi = min(lo + k2d, cfg.start_pis)
        if hi <= lo:
            raise ValueError("no spare kernel slots left for reseeding")
        rows = np.arange(lo, hi)
        musX = self.params.musX.detach().cpu().numpy().copy()
        pis[rows] = 1.0
        musX[rows] = mus3[:rows.size]
        with torch.no_grad():
            self.params.pis.copy_(torch.as_tensor(pis))
            self.params.musX.copy_(torch.as_tensor(musX))
        self.update_kernel_list()
        self.valid = False
        self.reinit_nu_from_argmax(rows=rows)
        return rows

    def reinit_inc(self, plot_dir=None, threshold_rel=0.2):
        from smoe_tpu_torch.fit.incremental import reinit_inc as _reinit
        with self._all_rows():
            _reinit(self, plot_dir=plot_dir, threshold_rel=threshold_rel)

    def apply_inc(self):
        from smoe_tpu_torch.fit.incremental import apply_inc as _apply
        with self._all_rows():
            _apply(self)
        if self._kgroup is not None:
            # on this rank's rows, not the gathered ones _apply reset it on
            self.set_inc_optimizer(reset=True)
