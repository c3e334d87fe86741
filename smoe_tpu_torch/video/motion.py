"""Global-motion compensation for video volumes, in PyTorch (from
smoe_tpu/video/motion.py:19-51; reference smoe.py:554-686).

Per-frame 2/4/6/8-parameter motion models applied to the (y, x, t) domain.
The transformed domain replaces the time coordinate with the constant -5,
so motion-compensated kernels are time-invariant.  The frame index of a
pixel is derived from its t coordinate (t = frame/(T-1) on the inclusive
linspace domain), so blocks need no frame bookkeeping.

The gather `motion[:, frame]` carries the gradient of the trainable motion
(`train_trafo`).  Its backward in torch is an `index_add_`, which on a CUDA
device adds with float atomics in an order that changes from run to run.
`_FrameGather` sums per frame instead: one masked `torch.sum` over the
pixels for each frame, a fixed reduction order, so two runs from one state
give the same bits.
"""

from __future__ import annotations

import torch

TIME_PLANE = -5.0   # reference smoe.py:684


class _FrameGather(torch.autograd.Function):
    """motion (8, T), fidx (N,) int64 -> motion[:, fidx] (8, N), with a
    backward that sums each frame's pixels in a fixed order."""

    @staticmethod
    def forward(ctx, motion, fidx):
        ctx.save_for_backward(fidx)
        ctx.num_frames = motion.shape[1]
        return motion.index_select(1, fidx)

    @staticmethod
    def backward(ctx, g):
        (fidx,) = ctx.saved_tensors
        zero = g.new_zeros(())
        cols = [torch.sum(torch.where((fidx == t)[None, :], g, zero), dim=1)
                for t in range(ctx.num_frames)]
        return torch.stack(cols, dim=1), None


def transform_coords(coords: torch.Tensor, motion: torch.Tensor,
                     num_params_model: int, num_frames: int) -> torch.Tensor:
    """Apply the per-frame global motion model to (N, 3) (y, x, t) coords.

    motion: (8, F) rows h11,h12,h13,h21,h22,h23,h31,h32.
    Returns (N, 3) [y', x', TIME_PLANE]  (reference smoe.py:665-684).
    Gradients flow to `motion` (and to coords' y and x).  torch.round is
    half-to-even, as jnp.round.
    """
    if num_params_model not in (2, 4, 6, 8):
        raise ValueError(f"invalid motion model {num_params_model}")
    y, x, t = coords[:, 0], coords[:, 1], coords[:, 2]
    fidx = torch.clamp(torch.round(t.detach() * (num_frames - 1)).to(
        torch.int64), 0, num_frames - 1)
    h = _FrameGather.apply(motion, fidx)                  # (8, N)
    h11, h12, h13, h21, h22, h23, h31, h32 = (h[i] for i in range(8))

    w_d = None
    if num_params_model == 2:
        x_d = x + h13
        y_d = y + h23
    elif num_params_model == 4:
        x_d = h11 * x + h12 * y + h13
        y_d = -h12 * x + h11 * y + h23
    else:
        x_d = h11 * x + h12 * y + h13
        y_d = h21 * x + h22 * y + h23
        if num_params_model == 8:
            w_d = h31 * x + h32 * y + 1.0
    if w_d is None:
        # JAX divides by the Python float 1.0, which is exact
        w_d = 1.0
    tp = torch.full_like(t, TIME_PLANE)
    return torch.stack([y_d / w_d, x_d / w_d, tp], dim=1)
