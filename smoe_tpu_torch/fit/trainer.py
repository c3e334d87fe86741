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

The JAX package compiles a chunk into one XLA program; PyTorch runs
eagerly, and the launches of a chunk are queued on the card without a
host sync in between.

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

Not ported yet, and raising NotImplementedError with their ROADMAP.md
Queue 1 item: `mesh=` (14), `sampling_percentage < 100` and `train_svs`
(12).
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smoe_tpu_torch.config import OptConfig, SmoeConfig
from smoe_tpu_torch.core import losses as L
from smoe_tpu_torch.core.init import get_batch_shape, init_params
from smoe_tpu_torch.core.model import (ForwardOut, clip_unit,
                                       expert_regression, fake_quant_unit,
                                       forward_fused, gating, maha_from_A,
                                       resolve_fused)
from smoe_tpu_torch.core.params import (SmoeParams, adam_state_from_numpy,
                                        assemble_A, params_from_numpy)
from smoe_tpu_torch.core.quant import apply_qat
from smoe_tpu_torch.core.ssim import ssim_loss
from smoe_tpu_torch.diag.profile import PhaseTimer
from smoe_tpu_torch.fit.blocks import (_block_view, build_blockset,
                                       initialize_kernel_lists, probe_points,
                                       row_chunks, stitch_blocks,
                                       update_kernel_lists)
from smoe_tpu_torch.video.motion import transform_coords

# the per-kernel fields of SmoeParams; a video fit also holds `motion`
# (`Smoe._fields`); the SV fields are not ported
PARAM_FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")
_MOTION_ROWS = ("h11", "h12", "h13", "h21", "h22", "h23", "h31", "h32")


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to smoe_tpu_torch yet "
                              f"(ROADMAP.md Queue 1 item {item})")


class RegWeights(NamedTuple):
    pis_l1: float
    u_l1: float
    sv_l1_sub_l2: float


class SweepMetrics(NamedTuple):
    """One sweep's metrics, on the device until the chunk's pull."""
    loss: torch.Tensor
    mse: torch.Tensor
    num_pi: torch.Tensor
    num_sv: torch.Tensor
    survivors: torch.Tensor      # (B, K)


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
                     musX_grid: Optional[torch.Tensor]) -> EffParams:
    """trainer.py:82-89."""
    eff = apply_qat(params, cfg)
    musX = eff.musX + musX_grid if (cfg.use_diff_center and musX_grid
                                    is not None) else eff.musX
    return EffParams(A=assemble_A(eff, cfg), musX=musX, nu_e=eff.nu_e,
                     gamma_e=eff.gamma_e, pis=eff.pis, motion=eff.motion)


def _forward_eff(eff: EffParams, cfg: SmoeConfig, coords: torch.Tensor,
                 kernel_mask: torch.Tensor, fused: bool = False,
                 sv_add: Optional[torch.Tensor] = None,
                 k_cap: Optional[int] = None,
                 model_mask: Optional[torch.Tensor] = None) -> ForwardOut:
    """Forward from the effective view (trainer.py:127-179, without the
    kernel-sharded branch).  fused: take the fused op (capped to k_cap)
    where the config allows it: not under train_inverse_cov, and not while
    the motion rows train (the fused op gives coords no gradient).

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
    if fused and not cfg.train_inverse_cov and not (
            eff.motion is not None and cfg.train_trafo):
        return forward_fused(eff.A, eff.musX, eff.nu_e, eff.gamma_e,
                             eff.pis, cfg, coords, kernel_mask,
                             sv_add=sv_add, k_cap=k_cap,
                             coords_raw=coords_raw, model_mask=model_mask)
    maha = maha_from_A(eff.A, eff.musX, cfg, coords, coords_raw, model_mask)
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    w_e = gating(maha, eff.pis, diag_A, cfg, kernel_mask)
    res = expert_regression(w_e, coords, eff.nu_e, eff.gamma_e, cfg)
    if sv_add is not None:
        res = torch.cat([res[:, :1] + sv_add[:, None], res[:, 1:]], dim=1)
    res = fake_quant_unit(clip_unit(res), cfg.precision)
    survivors = torch.any(w_e > cfg.minimum_influence, dim=0)
    return ForwardOut(res=res, w_e=w_e, survivors=survivors, maha=maha)


def _with_reg(loss_pix: torch.Tensor, eff: EffParams, cfg: SmoeConfig,
              kernel_mask: torch.Tensor, reg: RegWeights):
    """loss_pix + pis L1 + bandwidth L1 over the block's active kernels,
    in the JAX op order (trainer.py:231-243, 787-795).
    Returns (loss, num_active)."""
    active = kernel_mask & (eff.pis > 0)
    num_active = torch.sum(eff.pis > 0)
    s_pis = torch.sum(torch.where(active, eff.pis,
                                  torch.zeros_like(eff.pis)))
    diag_A = torch.diagonal(eff.A, dim1=1, dim2=2)
    s_diag = torch.sum(torch.where(active[:, None], diag_A,
                                   torch.zeros_like(diag_A)))
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
                model_mask: Optional[torch.Tensor] = None):
    """Loss of one block, differentiable in the raw params (trainer.py:
    186-250 without the SV branch).
    Returns (loss, (mse, survivors, err_map, num_active))."""
    eff = effective_params(params, cfg, musX_grid)
    out = _forward_eff(eff, cfg, coords, kernel_mask, fused=fused,
                       k_cap=k_cap, model_mask=model_mask)
    loss_pix, la = _pixel_term(out.res, targets, cfg, loss_w, valid,
                               block_padded)
    loss, num_active = _with_reg(loss_pix, eff, cfg, kernel_mask, reg)
    return loss, (la.mse, out.survivors, la.err_map, num_active)


def make_optimizer(params: SmoeParams, cfg: SmoeConfig,
                   opt_cfg: OptConfig, inc: bool = False) -> torch.optim.Adam:
    """One torch.optim.Adam over the reference's learning-rate groups,
    counterpart of `make_tx` (trainer.py:253-286): {nu_e, gamma_e, musX}
    at base_lr, pis at base_lr / lr_div, A (a_diag, a_corr) at
    base_lr * lr_mult, and under train_trafo the video motion rows at
    base_lr (the main optimizer only, not the inc one).  A group optax sets
    to zero (disabled or lr 0) is left out, so its tensors never move.  The
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
            ("motion", ("motion",), oc.base_lr,
             cfg.train_trafo and not inc and params.motion is not None)):
        if enabled and lr != 0:
            groups.append({"params": [getattr(params, f) for f in fields],
                           "lr": lr, "name": name, "fields": fields})
    # optax.adam's defaults; eps sits outside the sqrt in both
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def _check_ported(cfg: SmoeConfig) -> None:
    if cfg.compute_dtype != "float32":
        raise ValueError("compute_dtype must be 'float32': a bf16 maha is "
                         "a measured fault and is not ported")
    if cfg.train_svs:
        _not_ported("the SV residual (train_svs)", 12)


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
        device="cpu" to fit on the CPU)."""
        if mesh is not None:
            _not_ported("multi-GPU training (mesh=)", 14)
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
        _check_ported(cfg)
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
        self._main_rows = main
        self.inc_optimizer: Optional[torch.optim.Adam] = None
        self.phase_timer = PhaseTimer()

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
        if motion is not None:
            vals["motion"] = torch.as_tensor(np.array(motion, np.float32),
                                             device=self.device)
            self._fields = PARAM_FIELDS + ("motion",)
        if self.cfg.use_diff_center and (self.musX_grid is None
                                         or zero_diff):
            if self.musX_grid is None:
                self.musX_grid = vals["musX"]
            vals["musX"] = torch.zeros_like(vals["musX"])
        for f, t in vals.items():
            t.requires_grad_(f != "motion" or self.cfg.train_trafo)
        self.params = SmoeParams(**vals)

    def set_params(self, params) -> None:
        """Overwrite the raw parameters in place (the optimizer keeps its
        state).  params: a `SmoeParams`, or a dict keyed by field names or
        by the `get_params()` names, as `params_from_numpy` takes them."""
        new = params_from_numpy(params, device=self.device)
        with torch.no_grad():
            for f in self._fields:
                v = getattr(new, f, None)
                if v is not None:
                    getattr(self.params, f).copy_(v)
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
            eff0 = effective_params(self.params, cfg, self.musX_grid)
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
        `adam_state_from_numpy` takes."""
        opt = self.optimizer if optimizer is None else optimizer
        if opt is None:
            return None
        mu, nu, count = {}, {}, 0
        for g in opt.param_groups:
            for f, p in zip(g["fields"], g["params"]):
                st = opt.state.get(p)
                if st:
                    mu[f] = st["exp_avg"].detach().cpu().numpy()
                    nu[f] = st["exp_avg_sq"].detach().cpu().numpy()
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
                if f in state:
                    opt.state[p] = {
                        k: v.to(p.device) if k != "step" else v
                        for k, v in state[f].items()}

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

    def _sweep_grads(self, lists, reg: RegWeights, loss_w, k_cap):
        """Forward + backward over every block; the gradients are summed
        unweighted into .grad, zero-filled first so that every tensor the
        optimizer holds takes its step (optax updates a leaf from momentum
        alone; torch.optim.Adam skips a tensor whose grad is None).
        Returns (loss, mse, survivors (B, K)) on the device."""
        for p in self._trained():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        bw = self.block_weight
        zero = torch.zeros((), device=self.device)
        loss_acc, mse_acc = zero, zero
        survivors = []
        for b in range(self.start_batches):
            loss, (mse, surv, _, _) = _block_loss(
                self.params, self.cfg, self.bset.coords[b],
                self.bset.targets[b], lists[b], self._valid(b),
                None if loss_w is None else loss_w[b], reg, self.musX_grid,
                self.bset.block_padded, fused=self.fused, k_cap=k_cap,
                model_mask=self.model_mask)
            loss.backward()
            loss_acc = loss_acc + bw * loss.detach()
            mse_acc = mse_acc + bw * mse.detach()
            survivors.append(surv)
        return loss_acc, mse_acc, torch.stack(survivors)

    def _step(self, train_orig: bool = True, train_inc: bool = False) -> None:
        """One Adam step of the main optimizer on the main rows' gradients
        and, with train_inc, one of the inc optimizer on the inc rows'
        (trainer.py:602-617); without inc slots every row is a main row."""
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
        for opt, rows, on in ((self.optimizer, self._main_rows, train_orig),
                              (self.inc_optimizer, ~self._main_rows,
                               train_inc)):
            if not on:
                continue
            for p, g in zip(params, grads):
                p.grad = g * rows.reshape((-1,) + (1,) * (g.ndim - 1))
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

    def _check_sweep(self, sampling_percentage) -> None:
        if sampling_percentage < 100:
            _not_ported("sampling_percentage < 100 (subsampling)", 12)

    def run_batched_chunk(self, n_steps, pis_l1=0.0, u_l1=0.0,
                          sv_l1_sub_l2=0.0, sampling_percentage=100,
                          train_orig=True, train_inc=False, thr_sv=None,
                          use_loss_mask=False):
        """`n_steps` training sweeps with one host pull at the end
        (trainer.py:1240-1294).  Returns per-step numpy arrays (loss, mse,
        num_pi, num_sv); each step's metrics describe the params before
        that step's update."""
        self._check_sweep(sampling_percentage)
        if self.optimizer is None:
            self.set_optimizer()
        reg = RegWeights(float(pis_l1), float(u_l1), float(sv_l1_sub_l2))
        lw = self.loss_mask if use_loss_mask else None
        k_cap = self._current_k_cap()
        lists = self._kernel_lists
        rows = []
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        for _ in range(int(n_steps)):
            loss, mse, survivors = self._sweep_grads(lists, reg, lw, k_cap)
            with torch.no_grad():
                # metrics of the params before this step's update
                m = SweepMetrics(loss=loss, mse=mse, num_pi=torch.sum(
                    apply_qat(self.params, self.cfg).pis > 0), num_sv=zero,
                    survivors=survivors)
                if train_orig or train_inc:
                    self._step(train_orig, train_inc)
                lists = m.survivors
                if self.cfg.in_graph_ukl and not train_inc:
                    # survivors | probe-near under the updated params
                    # (trainer.py:631-654); not while the inc rows train:
                    # their pis are 0 until apply_inc, so a refresh would
                    # drop them from every list and cut their gradients
                    eff = effective_params(self.params, self.cfg,
                                           self.musX_grid)
                    lists = update_kernel_lists(eff.A, eff.musX, eff.pis,
                                                self.cfg, self.bset, lists,
                                                **self._probe_args(eff))
                kmax = torch.max(torch.sum(lists, dim=1))
                rows.append(torch.stack([m.loss, m.mse, m.num_pi.float(),
                                         m.num_sv.float(), kmax.float()]))
        # survivor feedback only shrinks the lists: keep the cached cap
        self._kernel_lists = lists
        self.valid = False
        ys = torch.stack(rows).cpu().numpy()       # the one host pull
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
        sweep minus both) and step.  Like the JAX version, `step` trains
        the model 2 * n_steps iterations as a side effect."""
        if self.optimizer is None:
            self.set_optimizer()
        kcap = self._current_k_cap()
        reg = RegWeights(0.0, 0.0, 0.0)
        lists = self.kernel_lists

        def fwd():
            for _ in range(n_steps):
                for b in range(self.start_batches):
                    _block_loss(self.params, self.cfg, self.bset.coords[b],
                                self.bset.targets[b], lists[b],
                                self._valid(b), None, reg, self.musX_grid,
                                self.bset.block_padded, fused=self.fused,
                                k_cap=kcap, model_mask=self.model_mask)

        def fwd_bwd():
            for _ in range(n_steps):
                self._sweep_grads(lists, reg, None, kcap)

        fwd_bwd()                                 # warm-up
        t_fwd = self._time_s(fwd) / n_steps
        t_fb = self._time_s(fwd_bwd) / n_steps
        self.run_batched_chunk(n_steps)           # warm at this cap
        t_step = self._time_s(lambda: self.run_batched_chunk(n_steps)) \
            / n_steps
        return {"fwd": t_fwd, "bwd": t_fb - t_fwd,
                "opt_metrics": t_step - t_fb, "step": t_step,
                "k_cap": float(kcap) if kcap is not None
                else float(self.cfg.capacity)}

    @torch.no_grad()
    def _eval_sweep(self, eff: EffParams, klists, loss_w, reg: RegWeights,
                    with_rec: bool, exact: bool):
        """Eval sweep (trainer.py:685-836).  with_rec or exact: the plain
        path, row-chunked, with the reconstruction and the gating argmax;
        otherwise the light validation
        through the fused op at full width.  Quantized-param evals (exact)
        must match the decoder, so they never take the fused op."""
        cfg = self.cfg
        bw = self.block_weight
        plain = with_rec or exact
        loss_acc = torch.zeros((), device=self.device)
        mse_acc = torch.zeros((), device=self.device)
        res_l, wam_l, surv_l = [], [], []
        for b in range(self.start_batches):
            coords, kmask = self.bset.coords[b], klists[b]
            if plain:
                s = row_chunks(coords.shape[0], int(cfg.capacity))
                m = coords.shape[0] // s
                outs = [_forward_eff(eff, cfg, coords[i * m:(i + 1) * m],
                                     kmask, model_mask=self.model_mask)
                        for i in range(s)]
                res = torch.cat([o.res for o in outs])
                surv = torch.stack([o.survivors for o in outs]).any(dim=0)
                if with_rec:
                    wam_l.append(torch.cat([torch.argmax(o.w_e, dim=1)
                                            for o in outs]))
            else:
                out = _forward_eff(eff, cfg, coords, kmask, fused=self.fused,
                                   model_mask=self.model_mask)
                res, surv = out.res, out.survivors
            loss_pix, la = _pixel_term(
                res, self.bset.targets[b], cfg,
                None if loss_w is None else loss_w[b], self._valid(b),
                self.bset.block_padded)
            loss, _ = _with_reg(loss_pix, eff, cfg, kmask, reg)
            loss_acc = loss_acc + bw * loss
            mse_acc = mse_acc + bw * la.mse
            surv_l.append(surv)
            if with_rec:
                res_l.append(res)
        num_pi = torch.sum(eff.pis > 0)
        rec = None
        if with_rec:
            rec = (torch.stack(res_l), torch.stack(wam_l))
        return loss_acc, mse_acc, torch.stack(surv_l), num_pi, rec

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

        reg = RegWeights(float(pis_l1), float(u_l1), float(sv_l1_sub_l2))
        lw = self.loss_mask if use_loss_mask else None
        with torch.no_grad():
            eff = self._eff_from_rparams() if with_quantized_params \
                else effective_params(self.params, self.cfg, self.musX_grid)
        kl = self.kernel_lists
        if self.cfg.in_graph_ukl:
            # dense validation: every active kernel (trainer.py:1375-1382)
            kl = (eff.pis > 0)[None, :].expand(kl.shape)
        loss, mse, surv, num_pi, rec = self._eval_sweep(
            eff, kl, lw, reg, with_rec=bool(update_reconstruction),
            exact=bool(with_quantized_params))
        h = torch.stack([loss, mse, num_pi.float()]).cpu().numpy()
        if update_reconstruction:
            res, wam = rec
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
            self._update_kernel_lists_from(surv)
        return float(h[0]), float(h[1]), int(h[2]), 0

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
        eff = effective_params(self.params, self.cfg, self.musX_grid)
        base = torch.zeros_like(self._kernel_lists) if replace \
            else self.kernel_lists
        self.kernel_lists = update_kernel_lists(
            eff.A, eff.musX, eff.pis, self.cfg, self.bset, base,
            **self._probe_args(eff))

    def _eff_from_rparams(self) -> EffParams:
        """Scatter the dequantized params back into full-capacity slots
        (dead slots pis=0) for the exact eval (trainer.py:1465-1492)."""
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
        t = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        with torch.no_grad():
            motion = apply_qat(self.params, self.cfg).motion
        return EffParams(A=t(A), musX=t(musX), nu_e=t(nu), gamma_e=t(gam),
                         pis=t(pis), motion=motion)

    def ls_init_experts(self, mode: str = "auto", ridge: float = 1e-6,
                        damp: float = 0.0, timings: Optional[dict] = None):
        """Closed-form least-squares (re)fit of the expert surfaces under
        the current gating (trainer.py:1722-1731, fit/lsinit.py).  Returns
        the gated pixel mass."""
        from smoe_tpu_torch.fit.lsinit import ls_refresh_experts
        return ls_refresh_experts(self, mode=mode, ridge=ridge, damp=damp,
                                  timings=timings)

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
        self._check_sweep(sampling_percentage)
        if ukl_iter is None:
            ukl_iter = val_iter
        if grad_clip_value_abs is not None and \
                grad_clip_value_abs != self.opt_cfg.grad_clip_value_abs:
            # the reference rebuilds its optimizers with the clip (fresh
            # state, smoe.py:1491)
            self.set_optimizer(grad_clip_value_abs=grad_clip_value_abs)
        if self.optimizer is None:
            self.set_optimizer()
        upd_rec = bool(callbacks)
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
                boundary = min(boundary,
                               ((i // ls_refresh_iter) + 1) * ls_refresh_iter)
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
                        loss_val, mse_val, num_pi, num_sv = self.run_batched(
                            pis_l1, u_l1, train=False)

                if ls_refresh_iter and i % ls_refresh_iter == 0:
                    # before the validation, so the snapshot sees the
                    # refreshed (non-regressing) experts
                    self.ls_init_experts(mode="kernel")
                    if not validate:
                        loss_val, mse_val, num_pi, num_sv = self.run_batched(
                            pis_l1, u_l1, train=False,
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
        (trainer.py:1656-1678), in one device-to-host copy."""
        with torch.no_grad():
            eff = apply_qat(self.params, self.cfg)
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
        (trainer.py:1764-1786); no torch object is pickled."""
        state = {
            "params": {f: getattr(self.params, f).detach().cpu().numpy()
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
        with open(path, "wb") as fd:
            pickle.dump(state, fd)
        print(f"Model saved in file: {path}")

    def restore(self, path: str):
        """Inverse of `checkpoint` (trainer.py:1788-1814)."""
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

    @torch.no_grad()
    def re_normalize_pis(self):
        """pis /= the sum of the listed, active pis, after a restore
        (trainer.py:1837-1845, reference smoe.py:774-775)."""
        pis = self.params.pis
        mask = torch.any(self.kernel_lists, dim=0) & (pis > 0)
        total = torch.sum(torch.where(mask, pis, torch.zeros_like(pis)))
        pis.copy_(pis / torch.clamp(total, min=1e-30))

    # ---------------- incremental kernels ----------------

    @torch.no_grad()
    def get_weight_matrix(self) -> np.ndarray:
        """The full (K, *spatial) gating map on the plain path, computed on
        demand (trainer.py:1733-1744)."""
        eff = effective_params(self.params, self.cfg, self.musX_grid)
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
        _reinit(self, plot_dir=plot_dir, threshold_rel=threshold_rel)

    def apply_inc(self):
        from smoe_tpu_torch.fit.incremental import apply_inc as _apply
        _apply(self)
