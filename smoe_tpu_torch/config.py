"""Model configuration: copies of `SmoeConfig` and `OptConfig` from
smoe_tpu/config.py:14-199.

The port carries its own copy because importing any `smoe_tpu` submodule
runs `smoe_tpu/__init__.py`, which imports jax.  Field names, defaults and
the derived properties (`minimum_influence` = 0.5/2^precision, :178-181)
are unchanged, so a `.smoe` header builds the same config in both packages.

Mirrors the hyperparameter surface of the reference `Smoe.__init__`
(reference smoe.py:38-41, ~30 kwargs) and the train CLI flags
(reference smoe_test.py:260-356), as one typed dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SmoeConfig:
    """Static configuration for an SMoE model fit.

    Everything in here is compile-time static for XLA: changing a field
    retriggers a trace.  Runtime state (params, kernel lists, RNG) lives in
    `SmoeParams` / `TrainState`.
    """

    # --- domain / kernels ---
    dim_domain: int = 2                      # 2 image, 3 video, 4 light field
    num_channels: int = 3
    kernels_per_dim: Tuple[int, ...] = (12, 12)
    precision: int = 8                       # input bit depth (8 or 16)

    # --- parameterization (reference smoe.py:38-41) ---
    train_pis: bool = True
    train_gammas: bool = True                # affine experts when True
    train_musx: bool = True
    use_diff_center: bool = False            # musX stored as offset from grid
    radial_as: bool = False                  # scalar bandwidth per kernel
    use_determinant: bool = True             # multiply N by prod(diag A)/sqrt((2pi)^d)
    train_inverse_cov: bool = False          # maha = x^T (D+L+L^T) x instead of |A^T x|^2
    normalize_pis: bool = True               # init pis to 1/K (else 1)
    only_y_gamma: bool = False               # slopes only on Y channel

    # --- loss (reference smoe.py:902-1051) ---
    use_yuv: bool = True                     # 6/8:1/8:1/8 channel weighting
    ssim_opt: bool = False                   # 1 - SSIM loss instead of eps-insensitive
    margin: float = 0.5                      # eps = margin / 2^precision

    # --- quantization (reference smoe.py:473-538, quantizer.py) ---
    quantization_mode: int = 0               # 0 none, 1 post-hoc each val, 2 QAT fixed, 3 QAT var
    bit_depths: Tuple[int, ...] = (20, 18, 6, 10, 10)   # A, musX, nu_e, pis, gamma_e
    quantize_pis: bool = False
    # Encoder-side steering-sign canonicalization (beyond reference; see
    # codec/quantize.canonicalize_steering).  A kernel trained into
    # prod(diag A) < 0 keeps maha invariant but flips its determinant-
    # normalizer sign — a fragile state that quantization perturbs
    # catastrophically (measured: CIF video decode 14.0 -> 24.4 dB, 278 of
    # 1280 kernels affected; 256^2 image 20.9 -> 27.2 dB from ONE kernel).
    canonicalize_steering: bool = True
    # Center-anchored expert-offset coding (beyond reference): code
    # nu' = nu + gamma_q . mu_q — the expert surface's value AT the
    # decoded kernel center (naturally in ~[0,1]) instead of its
    # extrapolation to the origin (reference gamma^T x + nu,
    # smoe.py:845).  The decoder inverts exactly from its own
    # dequantized gamma/musX.  Matters for LS-initialized fits, whose
    # honest steep slopes push origin-nu to +-5 and stretch the
    # data-derived 6-bit nu bounds (codec/quantize.py; measured in
    # scripts/exp_lsri_quant.py).  Off by default: parity mode codes nu
    # exactly like reference quantizer.py.  Ignored under QM2 (fixed
    # user bounds refer to origin-nu).
    nu_anchor: bool = False
    # Steering-whitened slope coding (beyond reference, the nu_anchor idea
    # extended to gamma): code w = M^-1 gamma per channel, where M is the
    # decoded steering factor A_q with its diagonal magnitude floored at
    # gamma_anchor_eps (deterministic from A_q on both sides, so decode is
    # exact: gamma = M w_q).  w has the unit "signal change per unit
    # Mahalanobis distance" — a steep slope across a SHARP kernel (large A)
    # codes small, so LS-refreshed fits stop stretching the shared
    # data-derived gamma bounds (at d=3 gamma is 9 fields/kernel; the
    # stretch cost the video -lsri recipe a measured 3.1 dB train->decode
    # gap, ROADMAP 6b''').  Off by default (parity: reference codes raw
    # gamma).  Ignored under QM2 (fixed user bounds refer to raw gamma)
    # and under train_inverse_cov (no triangular factor to whiten with).
    gamma_anchor: bool = False
    gamma_anchor_eps: float = 1.0            # |diag M| floor (domain [0,1]^d)
    # Light-field corner-view loss weight (beyond reference): the reference
    # EXCLUDES the 15x15 view grid's corner views from the loss entirely
    # (smoe.py:2374-2389) and the fit measurably overfits the trained-view
    # mask (8.3 dB trained/all-views gap at the lsri point, BASELINE).
    # When > 0, corner views enter the loss at this linear per-pixel
    # weight (core/losses.pixel_loss float valid path; the LS solves use
    # the same row weight) instead of being dropped.  0 = reference.
    lf_corner_weight: float = 0.0
    lower_bounds: Tuple[float, ...] = (-2500.0, -0.3, -5.0, 0.0, -32.0)
    upper_bounds: Tuple[float, ...] = (2500.0, 1.3, 5.0, 2.0, 32.0)

    # --- blocks (reference smoe.py:18-35, 2459-2543) ---
    block_shape: Tuple[int, ...] = ()        # pixels per block per dim (no overlap)
    overlap: int = 0                         # overlap_of_batches

    # --- incremental kernels (reference smoe.py:339-452, 1206-1483) ---
    add_kernel_slots: int = 0

    # --- video motion (reference smoe.py:554-686) ---
    train_trafo: bool = False
    num_params_model: int = 6                # 2 / 4 / 6 / 8 motion params
    num_frames: int = 0                      # frames (dim_domain==3 only)
    dual_model: bool = False                 # fg/bg dual kernel set (smoe.py:280-329)
    start_pis_override: int = 0              # data-dependent K (video init strategies)

    # --- misc ---
    kernel_count_as_norm_l1: bool = False
    train_svs: bool = False                  # support-vector residual (smoe.py:402-426)
    sv_threshold: float = 0.02               # thr_sv zeroing bound (smoe.py:404, 852)
    # SV storage under block overlap.  False (default): each block owns
    # independent SVs for its padded window — overlapped pixels carry one SV
    # per covering block (the reference's masking here is ambiguous,
    # smoe.py:411-426).  True: ONE SV per image pixel on the global raster
    # grid; blocks gather their window's rows, so overlapping blocks share
    # and co-train the same coefficients (gradients scatter-add through the
    # gather), and synthetic image-edge pad positions contribute nothing.
    sv_shared_grid: bool = False
    # matmul dtype; "bfloat16" opt-in. Measured on v5e: bf16 does NOT help
    # (5.1 vs 4.4 ms/iter at 512^2) — the maha contraction is only F=8 wide
    # so the matmul is cast-overhead-bound, and PSNR is unchanged.
    compute_dtype: str = "float32"
    # auto/on/off.  ("packed" — an in-kernel tile-culling variant — was
    # REMOVED in round 4: slower than auto's capped-dense at every
    # measured size AND conclusively faulted the TPU worker at the
    # 4K/K=9216 trainer config; see ROADMAP.md "Block sparsity".)
    use_pallas: str = "auto"
    # kernel-list probe threshold (reference smoe.py:806 hardcodes 800).
    # Measured on config 3 (1080p, 16 blocks, K=576): 150 -> -15% step
    # time, 50 -> -23%, both at unchanged PSNR — exp(-0.5*50) ~ 1e-11 is
    # far below the influence cull, so probe-distant kernels are dead
    # weight.  800 kept as the reference-faithful default.
    probe_maha_threshold: float = 800.0
    # Refresh the per-block kernel lists IN-GRAPH every sweep
    # (lists <- influence survivors | probe-near) instead of only at the
    # host-side ukl_iter cadence.  The reference cannot do this (its
    # lists ride the per-block feed_dict, smoe.py:1672); with a compiled
    # whole-sweep program the probe maha is a tiny (B*3^d, K) matmul.
    # Why it matters: a kernel culled from a block's list keeps training
    # on OTHER blocks and drifts; by the next host refresh its influence
    # in the culled block is stale garbage.  Measured on the CIF video
    # recipe (round 3): at ukl=500 the DECODED PSNR lags the in-list
    # eval by >10 dB; per-sweep refresh bounds the drift at one sweep.
    in_graph_ukl: bool = False
    # probe points per dim for the kernel-list boxes (3 = the reference's
    # {min, mid, max}; 5 halves the spacing and shrinks the sharp-kernel
    # boundary leak — see probe_points)
    probe_grid: int = 3

    @property
    def num_kernels_grid(self) -> int:
        import numpy as np
        return int(np.prod(self.kernels_per_dim))

    @property
    def capacity(self) -> int:
        """Total kernel slots: grid + inc block + add slots.

        Matches reference smoe.py:337-340: with add_kernel_slots>0 the live
        arrays hold `add_kernel_slots + 2*start_pis` kernels (main block of
        start_pis+add_kernel_slots and an inc block of start_pis).
        """
        k = self.start_pis
        if self.add_kernel_slots > 0:
            return self.add_kernel_slots + 2 * k
        return k

    @property
    def start_pis(self) -> int:
        if self.start_pis_override > 0:
            return self.start_pis_override
        return self.num_kernels_grid * (2 if self.dual_model else 1)

    @property
    def epsilon(self) -> float:
        return self.margin / (2 ** self.precision)

    @property
    def minimum_influence(self) -> float:
        # reference smoe.py:825
        return 0.5 / (2 ** self.precision)

    def replace(self, **kw) -> "SmoeConfig":
        return dataclasses.replace(self, **kw)


# Default Adam learning-rate structure (reference smoe_test.py:84-97):
#   group 1 {nu_e, gamma_e, musX}: base_lr
#   group 2 {pis}:                 base_lr / lr_div        (default /100)
#   group 3 {A_diag, A_corr}:      base_lr * lr_mult       (default x1000)
#   group 4 {SV}:                  base_lr * lr_mult_sv
#   group 5 {motion h**}:          base_lr
@dataclasses.dataclass(frozen=True)
class OptConfig:
    base_lr: float = 1e-3
    lr_div: float = 100.0
    lr_mult: float = 1000.0
    lr_mult_sv: float = 1.0
    grad_clip_value_abs: Optional[float] = None
