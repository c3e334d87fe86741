"""JAX's collective semantics under shard_map, as torch.distributed calls
(the role of smoe_tpu/parallel/compat.py, which holds jax's `pvary`).

Under shard_map with varying-axis typing the two collectives of a kernel-
sharded forward transpose as follows, and the port must keep both rules or
its gradients are silently wrong:

  * `psum(x, group)`: forward all-reduce SUM, backward the identity.  A loss
    computed the same way on every rank of the group differentiates to the
    true gradient on each rank.  torch.distributed.nn's all_reduce reduces
    the gradient again in its backward, which would give nk times the
    gradient of such a loss.
  * `pvary(x, group)`: forward the identity, backward all-reduce SUM.  JAX
    inserts it wherever an invariant value (the psum'd gating denominator)
    enters per-rank arithmetic: each rank's cotangent then holds only its
    own kernels' share, and the sum restores the whole.

`pmin` / `pmax` take detached tensors only (the QAT-3 bounds carry no
gradient, quant.py:61-68).  `gather_rows` places each rank's rows of a
zero-filled slab and all-reduces it: exact (every sum adds zeros to one
value) and taken by NCCL and by gloo on CUDA tensors alike.

Every function is a no-op for group=None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.psum: all-reduce SUM forward, identity backward."""
    return x if group is None else _Psum.apply(x, group)


def pvary(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's implicit pvary: identity forward, all-reduce SUM backward."""
    return x if group is None else _Pvary.apply(x, group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.pmin of a value without gradient."""
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.pmax of a value without gradient."""
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def all_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce SUM of a buffer without gradient; returns it."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, rows: slice, total: int, group,
                dim: int = 0) -> torch.Tensor:
    """The whole (total, ...) tensor from each rank's `rows` along `dim`:
    a zero-filled slab with this rank's rows written, all-reduced."""
    if group is None:
        return x
    shape = list(x.shape)
    shape[dim] = total
    slab = x.new_zeros(shape)
    slab.narrow(dim, rows.start, rows.stop - rows.start).copy_(x)
    dist.all_reduce(slab, group=group)
    return slab


def rank_range(n: int, parts: int, rank: int) -> slice:
    """Rank `rank`'s contiguous share of n items in `parts` equal parts."""
    if n % parts:
        raise ValueError(f"{n} does not divide into {parts} equal parts")
    step = n // parts
    return slice(rank * step, (rank + 1) * step)


def group_of(mesh, name: str) -> Optional[object]:
    """The process group of a mesh dimension (of any size, so that a world
    of one still runs its collectives), or None without that dimension."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)


def size_rank(mesh, name: str):
    """(size, this rank's index) of a mesh dimension; (1, 0) without it."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1, 0
    return (mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name))
