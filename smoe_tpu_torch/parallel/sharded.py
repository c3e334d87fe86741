"""Multi-GPU SMoE training on a (blocks, kernels) DeviceMesh (from
smoe_tpu/parallel/sharded.py).

One process per card, as torch.distributed runs.  The two parallel axes of
the JAX package map onto the dimensions of a `DeviceMesh` named ("b", "k"),
their collectives onto the dimensions' process groups (NCCL on the card,
gloo on the CPU; parallel/compat.py):

  * 'b' splits the pixel blocks: each rank sweeps its B/nb blocks with the
    same per-block loss, and one psum over 'b' sums the gradients (the
    reference's block-sequential gradient accumulation, smoe.py:1145-1151).
  * 'k' splits the kernel rows: the gating denominator and the partial
    expert sums become psums over 'k' (core/model.py), the QAT-3 bounds a
    pmin (core/quant.py), the regularizers' live count and sums one psum.
  * `fit_many` fans M independent fits out over a one-dimensional mesh.

The full trainer over a mesh is `Smoe(mesh=...)` (fit/trainer.py); this
module holds the kernel-axis train step and the fan-out.  JAX's
`_sharded_forward` (sharded.py:68-85) is the trainer's
`_forward_eff(..., kernel_group=)`, which the step reaches through
`_block_loss`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.params import SmoeParams
from smoe_tpu_torch.fit.trainer import (PARAM_FIELDS, RegWeights, Smoe,
                                        _block_loss)
from smoe_tpu_torch.parallel.compat import (all_sum_, gather_rows, group_of,
                                            rank_range, size_rank)


def make_mesh(n_blocks: int, n_kernels: int = 1, device_type=None):
    """A ("b", "k") DeviceMesh over the n_blocks * n_kernels processes of
    the world (sharded.py:46-53).  device_type: "cuda" or "cpu" (default:
    "cuda" where a card is present)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n_blocks * n_kernels
    if dist.get_world_size() != n:
        raise ValueError(f"a {n_blocks} x {n_kernels} mesh needs a world of "
                         f"{n} processes, this one has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), (n_blocks, n_kernels),
                            mesh_dim_names=("b", "k"))


def axis_mesh(name: str = "m", device_type=None):
    """A one-dimensional DeviceMesh over the whole world: the "m" axis of
    `fit_many`, or the pixel axis of the serving decode."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type),
                            (dist.get_world_size(),), mesh_dim_names=(name,))


def _device_type(device_type) -> str:
    if device_type is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device_type).type


def _param_specs(params: SmoeParams) -> dict:
    """Field -> "k" for the kernel-indexed fields, None for the replicated
    ones, motion and SV (sharded.py:56-65); absent fields left out."""
    return {f.name: ("k" if f.name in PARAM_FIELDS else None)
            for f in dataclasses.fields(params)
            if getattr(params, f.name) is not None}


def adam(lr: float, eps: float = 1e-8):
    """An optimizer factory for `make_sharded_train_step`: optax.adam's
    defaults over every trained tensor of a SmoeParams."""
    def make(params: SmoeParams) -> torch.optim.Adam:
        return torch.optim.Adam(
            [t for t in (getattr(params, f.name)
                         for f in dataclasses.fields(params))
             if t is not None and t.requires_grad],
            lr=lr, betas=(0.9, 0.999), eps=eps)
    return make


def make_sharded_train_step(cfg: SmoeConfig, mesh, tx, block_weight: float):
    """The kernel-axis TP/EP train step (sharded.py:88-162).

    tx: an optimizer factory (`adam(lr)`), called on the params from
    `shard_inputs`.  The step takes
      params     SmoeParams, this rank's kernel rows (leaf tensors)
      opt_state  tx(params)
      coords     (B/nb, Nb, d), targets (B/nb, Nb, C): this rank's blocks
      klists     (B/nb, K/nk) bool
      pis_l1, u_l1
    and runs one sweep over the rank's blocks (the trainer's `_block_loss`
    on the plain path, with `kernel_group`), one psum over 'b' of the
    gradients with the loss and mse, then the optimizer's step on the rank's
    rows.  Returns (params, opt_state, loss, mse) with loss, mse floats."""
    nk, _ = size_rank(mesh, "k")
    kg = group_of(mesh, "k") if nk > 1 else None
    bg = group_of(mesh, "b")
    padded = tuple(cfg.block_shape or ())

    def step(params, opt_state, coords, targets, klists, pis_l1, u_l1):
        leaves = list(opt_state.param_groups[0]["params"])
        for p in leaves:
            p.grad = torch.zeros_like(p)
        reg = RegWeights(float(pis_l1), float(u_l1), 0.0)
        zero = torch.zeros((), device=coords.device)
        loss_acc, mse_acc = zero, zero
        for b in range(coords.shape[0]):
            loss, (mse, _, _, _) = _block_loss(
                params, cfg, coords[b], targets[b], klists[b], None, None,
                reg, None, padded, kernel_group=kg)
            loss.backward()
            loss_acc = loss_acc + block_weight * loss.detach()
            mse_acc = mse_acc + block_weight * mse.detach()
        flat = all_sum_(torch.cat([p.grad.reshape(-1) for p in leaves]
                                  + [loss_acc.reshape(1),
                                     mse_acc.reshape(1)]), bg)
        i = 0
        for p in leaves:
            p.grad.copy_(flat[i:i + p.numel()].reshape(p.shape))
            i += p.numel()
        opt_state.step()
        return params, opt_state, float(flat[i]), float(flat[i + 1])

    return step


def shard_inputs(mesh, params, coords, targets, klists):
    """This rank's share of each input (sharded.py:165-177): the kernel
    rows of `params` by 'k' rank (leaf tensors taking gradients), the
    blocks of coords and targets by 'b' rank, klists by both.  Inputs may
    be numpy arrays or tensors; the outputs lie on the mesh's device."""
    dev = torch.device(mesh.device_type)
    nb, rb = size_rank(mesh, "b")
    nk, rk = size_rank(mesh, "k")

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=dev)

    K = int(np.asarray(params.pis).shape[0])
    rows = rank_range(K, nk, rk)
    specs = _param_specs(params)
    vals = {}
    for f, spec in specs.items():
        v = t(getattr(params, f))
        vals[f] = (v[rows] if spec == "k" else v).clone().requires_grad_()
    blocks = rank_range(int(np.asarray(coords).shape[0]), nb, rb)
    return (SmoeParams(**vals), t(coords)[blocks], t(targets)[blocks],
            t(klists, torch.bool)[blocks, rows])


def gather_params(mesh, params: SmoeParams) -> dict:
    """The whole model as numpy from every 'k' rank's rows (every rank
    calls it)."""
    nk, rk = size_rank(mesh, "k")
    kg = group_of(mesh, "k") if nk > 1 else None
    K = params.pis.shape[0] * nk
    rows = rank_range(K, nk, rk)
    out = {}
    for f, spec in _param_specs(params).items():
        v = getattr(params, f).detach()
        if spec == "k":
            v = gather_rows(v, rows, K, kg)
        out[f] = v.cpu().numpy()
    return out


def fit_many(images, cfg: SmoeConfig, steps: int = 100, mesh=None,
             opt_cfg=None, pis_l1=0.0, u_l1=0.0, block_shape=None,
             refresh_every: Optional[int] = None, ls_init: bool = False,
             device=None):
    """Data-parallel RD-sweep fan-out: M independent fits (sharded.py:180-
    352), each the trainer's own sweep (`Smoe.run_batched_chunk`: the
    `_block_loss` with its QAT, the regularizers at this model's weights,
    the 5-group Adam, per-block lists with survivor feedback; on the card
    through K1/K2).  The JAX package vmaps the plain path over the models;
    the port has no vmap over its kernels and fits them one after another.

    images: (M, *spatial, C) of one shape.  pis_l1 / u_l1: scalars or (M,).
    mesh: a one-dimensional DeviceMesh; rank r fits models
    [r M / n, (r + 1) M / n) and every rank gets every model's result.
    Without a mesh one process fits all M.  block_shape (or
    cfg.block_shape): blocks per model, default one.  refresh_every: every
    N sweeps also OR the probe-near kernels into the lists
    (`update_kernel_list`).  ls_init: solve the experts in closed form
    (kernel mode, line-searched) before the first sweep.  The SV residual
    stays `Smoe`-only.  device: default the mesh's, else "cuda".
    Returns (SmoeParams of (M, ...) numpy raw params, (M,) final mses)."""
    if cfg.train_svs:
        raise ValueError("fit_many: the SV residual is Smoe-only "
                         "(per-image SV state)")
    imgs = np.asarray(images, np.float32)
    m = imgs.shape[0]
    r1 = np.broadcast_to(np.asarray(pis_l1, np.float32), (m,))
    r2 = np.broadcast_to(np.asarray(u_l1, np.float32), (m,))
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    n, r = (1, 0) if mesh is None else (mesh.size(), mesh.get_local_rank())
    mine = rank_range(m, n, r)
    bs = block_shape or cfg.block_shape or None
    # JAX's fan-out refreshes its lists from the survivors only
    cfg = cfg.replace(in_graph_ukl=False)
    fits = {}
    for i in range(mine.start, mine.stop):
        s = Smoe(imgs[i], cfg=cfg, opt_cfg=opt_cfg, device=device,
                 batch_size=tuple(bs) if bs else None)
        s.set_optimizer()
        if ls_init:
            s.ls_init_experts(mode="kernel")
        seg = steps if not refresh_every or s.start_batches == 1 \
            else int(refresh_every)
        done, mse = 0, np.zeros((1,), np.float32)
        while done < steps:
            k = min(seg, steps - done)
            _, mse, _, _ = s.run_batched_chunk(k, pis_l1=float(r1[i]),
                                               u_l1=float(r2[i]))
            done += k
            if done < steps:
                s.update_kernel_list()
        fits[i] = (s.params, float(mse[-1]))
    # every model's raw params and mse to every rank: one all-reduce of a
    # zero-filled (M, P + 1) slab
    ref = next(iter(fits.values()))[0]
    fields = [f for f in _param_specs(ref)]
    shapes = [tuple(getattr(ref, f).shape) for f in fields]
    width = sum(int(np.prod(sh)) for sh in shapes) + 1
    dev = ref.pis.device
    slab = torch.zeros((m, width), device=dev)
    for i, (p, mse) in fits.items():
        slab[i] = torch.cat([getattr(p, f).detach().reshape(-1)
                             for f in fields]
                            + [torch.full((1,), mse, device=dev)])
    if mesh is not None:
        all_sum_(slab, mesh.get_group())
    out = slab.cpu().numpy()
    vals, j = {}, 0
    for f, sh in zip(fields, shapes):
        w = int(np.prod(sh))
        vals[f] = out[:, j:j + w].reshape((m,) + sh)
        j += w
    return SmoeParams(**vals), out[:, -1].copy()
