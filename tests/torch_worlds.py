"""What the port's mesh tests run inside worlds of spawned processes
(smoe_tpu_torch.parallel.launch.run_world("tests/torch_worlds.py:<fn>",
...)): each function takes (rank, world, **kwargs), builds its meshes over
the world and returns plain numpy / Python results.  Torch, numpy and the
port only: a worker never imports jax."""

import os
import sys

import numpy as np
import torch

from smoe_tpu_torch.codec.serve import decode_bitstream
from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.init import init_params
from smoe_tpu_torch.fit.blocks import build_blockset
from smoe_tpu_torch.fit.trainer import RegWeights, Smoe
from smoe_tpu_torch.parallel.compat import gather_rows, size_rank
from smoe_tpu_torch.parallel.multihost import primary, save_checkpoint
from smoe_tpu_torch.parallel.sharded import (adam, axis_mesh, fit_many,
                                             gather_params, make_mesh,
                                             make_sharded_train_step,
                                             shard_inputs)

SWEEPS = 10
# this clip's mse bumps at sweep 8, which magnifies the packages' rounding
# differences to ~5e-3: the 'b' video case stops before it
VIDEO_SWEEPS = 6
REG = dict(pis_l1=1e-4, u_l1=1e-6)


def img32():
    y, x = np.mgrid[0:32, 0:32] / 31.0
    return np.stack([.5 + .3 * np.sin(5 * x),
                     .5 + .3 * np.cos(4 * y + 2 * x),
                     .4 + .2 * np.sin(3 * (x + y))], -1).astype(np.float32)


def vid16():
    t = np.linspace(0, 1, 4)[None, None, :, None]
    y, x = np.mgrid[0:16, 0:16] / 15.0
    return np.clip(0.5 + 0.3 * np.sin(5 * x[..., None, None] + 2 * t)
                   + 0.1 * np.cos(4 * y[..., None, None]), 0, 1
                   ).astype(np.float32)


def img_tall(h=64):
    """tests/test_multihost_e2e.py's worker image at a fixed 64 x 16."""
    y, x = np.mgrid[0:h, 0:16] / (h - 1)
    return np.stack([0.5 + 0.3 * np.sin(5 * x + 40 * y),
                     0.5 + 0.3 * np.cos(4 * x + 80 * y),
                     0.4 + 0.2 * np.sin(3 * (x + 20 * y))],
                    -1).astype(np.float32)


def fan_images():
    y, x = np.mgrid[0:16, 0:16] / 15.0
    return np.stack([np.stack([.5 + .3 * np.sin(5 * x + i),
                               .5 + .3 * np.cos(4 * y),
                               .4 + .2 * np.sin(3 * (x + y))], -1)
                     for i in range(2)]).astype(np.float32)


FAN_CFG = dict(dim_domain=2, num_channels=3, kernels_per_dim=(3, 3))
FAN_REG = [0.0, 3e-3]


def tp_setup(qm=0):
    """tests/test_parallel.py's setup: 16 x 16 x 1, 16 kernels, 8 blocks
    of 4 x 8."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.2, 0.8, (16, 16, 1)).astype(np.float32)
    cfg = SmoeConfig(dim_domain=2, num_channels=1, kernels_per_dim=(4, 4),
                     use_yuv=False, use_determinant=True,
                     quantization_mode=qm)
    bset = build_blockset(img, cfg, (4, 8))
    return cfg, init_params(img, cfg), bset


def partial_lists(K=16):
    kl = np.zeros((8, K), bool)
    for b in range(8):
        kl[b, (b % 4):(b % 4) + 12] = True
    return kl


def _tp_step(mesh, qm, klists, pis_l1, u_l1):
    cfg, params, bset = tp_setup(qm)
    p, coords, targets, kl = shard_inputs(mesh, params, bset.coords,
                                          bset.targets, klists)
    step = make_sharded_train_step(cfg, mesh, adam(1e-3), block_weight=1 / 8)
    p, _, loss, mse = step(p, adam(1e-3)(p), coords, targets, kl, pis_l1,
                           u_l1)
    return {"loss": loss, "mse": mse, "params": gather_params(mesh, p)}


def tp_steps(rank, world):
    """The TP step at every mesh shape this world holds: all-on lists,
    partial lists with both regularizers, and (on (2, 2)) QAT 3."""
    out = {}
    for shape in {2: [(2, 1)], 4: [(2, 2), (1, 4)]}[world]:
        mesh = make_mesh(*shape, device_type="cpu")
        out[shape] = {
            "plain": _tp_step(mesh, 0, np.ones((8, 16), bool), 0.0, 0.0),
            "reg": _tp_step(mesh, 0, partial_lists(), 1e-4, 1e-6)}
        if shape == (2, 2):
            out[shape]["qat3"] = _tp_step(mesh, 3, np.ones((8, 16), bool),
                                          0.0, 0.0)
    return out


def _chunk(s, n=SWEEPS, **kw):
    loss, mse, npi, _ = s.run_batched_chunk(n, **kw)
    return {"loss": loss, "mse": mse, "num_pi": npi,
            "lists": s.kernel_lists.cpu().numpy(), "params": s.get_params()}


def trainer_fits(rank, world):
    """Smoe(mesh=) on 'b' (2 or 4 ranks) and on ('b', 'k') (2, 2): one chunk
    of SWEEPS sweeps with kernel lists and both regularizers, beside the
    trained model's eval and reconstruction on the 2-rank world."""
    out = {}
    for shape in {2: [(2, 1)], 4: [(4, 1), (2, 2)]}[world]:
        s = Smoe(img32(), kernels_per_dim=[4], batch_size=(8, 8),
                 mesh=make_mesh(*shape, device_type="cpu"), device="cpu")
        s.set_optimizer()
        out[shape] = _chunk(s, **REG)
        if shape == (2, 1):
            loss, mse, npi, _ = s.run_batched(train=False,
                                              update_reconstruction=True)
            out[shape]["eval"] = (loss, mse, npi)
            out[shape]["rec"] = s.get_reconstruction()
    if world == 4:
        out["grads"] = grads_bk()
        out["grads_motion"] = grads_bk(video=True)
    else:
        out["fit_many"] = fit_many(fan_images(), SmoeConfig(**FAN_CFG),
                                   steps=8, mesh=axis_mesh("m", "cpu"),
                                   pis_l1=np.asarray(FAN_REG, np.float32),
                                   device="cpu")
    return out


def _video_smoe(**kw):
    return Smoe(vid16(), kernels_per_dim=[3, 3, 2], use_yuv=False,
                batch_size=(8, 8, 4), train_trafo=True, num_params_model=4,
                device="cpu", **kw)


def grads_bk(video=False):
    """One sweep's gradients on a (2, 2) mesh, every kernel row gathered,
    beside the one-process gradients from the same state (QAT 3, both
    regularizers; or the video fit with its motion rows)."""
    mesh = make_mesh(2, 2, device_type="cpu")
    runs = []
    for m in (mesh, None):
        s = _video_smoe(mesh=m) if video else Smoe(
            img32(), kernels_per_dim=[4], batch_size=(8, 8),
            quantization_mode=3, device="cpu", mesh=m)
        s.set_optimizer()
        loss, mse, _, _ = s._sweep_grads(s.kernel_lists,
                                         RegWeights(1e-4, 1e-6, 0.0), None,
                                         None)
        g = {f: s._gather_rows(getattr(s.params, f).grad, f).cpu().numpy()
             for f in s._fields}
        runs.append({"loss": float(loss), "mse": float(mse), "grads": g})
    return {"mesh": runs[0], "one": runs[1]}


def serve_and_variants(rank, world, smoe_path, roi):
    """The decode split over the world against this process's decode
    without a mesh; SSIM and the video motion rows over 'b'."""
    mesh = axis_mesh("x", "cpu")
    out = {"split": decode_bitstream(smoe_path, device="cpu", mesh=mesh,
                                     roi=tuple(map(tuple, roi)),
                                     chunk_pixels=1024),
           "one": decode_bitstream(smoe_path, device="cpu",
                                   roi=tuple(map(tuple, roi)),
                                   chunk_pixels=1024)}
    s = Smoe(img32(), kernels_per_dim=[4], batch_size=(16, 16),
             ssim_opt=True, mesh=make_mesh(2, 1, device_type="cpu"),
             device="cpu")
    s.set_optimizer()
    out["ssim"] = _chunk(s, 8)
    s = Smoe(vid16(), kernels_per_dim=[3, 3, 2], use_yuv=False,
             batch_size=(8, 8, 4), mesh=make_mesh(2, 1, device_type="cpu"),
             device="cpu")
    s.set_optimizer()
    out["video"] = _chunk(s, VIDEO_SWEEPS)
    s = _video_smoe(mesh=make_mesh(1, 2, device_type="cpu"))
    s.set_optimizer()
    out["video_k"] = _chunk(s)
    out["video_k"]["motion"] = s.params.motion.detach().numpy()
    return out


def fleet(rank, world, out_dir, resume_from="", kind="b"):
    """tests/test_multihost_e2e.py's worker: 8 blocks of 8 x 16 over the
    world's 'b' axis (kind "bk": 'k' of 2 and 16 kernels), two sweeps with
    a validation, a rank-0 checkpoint."""
    nk = 2 if kind == "bk" else 1
    s = Smoe(img_tall(), kernels_per_dim=[4] if kind == "bk" else [3],
             batch_size=(8, 16), device="cpu",
             mesh=make_mesh(world // nk, nk, device_type="cpu"))
    s.set_optimizer()
    if resume_from:
        s.restore(resume_from)
    s.train(2, val_iter=2, pis_l1=1e-4)
    wrote = save_checkpoint(s, os.path.join(out_dir, f"ckpt_{rank}.pkl"))
    return {"rank": rank, "loss": float(s.losses[-1][1]), "iter": s.iter,
            "mesh_b": size_rank(s.mesh, "b")[0], "primary": primary(),
            "wrote_checkpoint": wrote,
            "jax_loaded": any(m.split(".")[0] in ("jax", "smoe_tpu")
                              for m in sys.modules)}


def fleet_bk(rank, world, out_dir):
    """The ('b', 'k') fleet, then six blocks over the same world's 'b'
    axis."""
    return {"fleet": fleet(rank, world, out_dir, kind="bk"),
            "non_dividing": non_dividing(rank, world)}


def non_dividing(rank, world):
    """Six blocks over a 4-way 'b' axis: JAX shrinks to 3 devices in one
    process; with a process a rank the shrink would orphan one."""
    y, x = np.mgrid[0:24, 0:32] / 23.0
    img = np.stack([.5 + .3 * np.sin(5 * x), .5 + .3 * np.cos(4 * y + 2 * x),
                    .4 + .2 * np.sin(3 * (x + y))], -1).astype(np.float32)
    try:
        Smoe(img, kernels_per_dim=[4], batch_size=(8, 16), device="cpu",
             mesh=make_mesh(world, 1, device_type="cpu"))
    except ValueError as e:
        return str(e)
    return None


def world_grads_are_exact(rank, world):
    """A psum with an all-reduce in its backward would double this
    gradient on a 2-way group; JAX's rule keeps it."""
    from smoe_tpu_torch.parallel.compat import psum, pvary
    g = torch.distributed.group.WORLD
    x = torch.tensor([1.0 + rank], requires_grad=True)
    psum(2 * x, g).sum().backward()
    y = torch.tensor([1.0 + rank], requires_grad=True)
    (pvary(y, g) * (rank + 1)).sum().backward()
    rows = gather_rows(torch.tensor([[float(rank)]]), slice(rank, rank + 1),
                       world, g)
    return {"psum_grad": float(x.grad), "pvary_grad": float(y.grad),
            "rows": rows.reshape(-1).tolist(),
            "jax_loaded": any(m.split(".")[0] in ("jax", "smoe_tpu")
                              for m in sys.modules)}


def parallel_world(rank, world):
    """tests/test_torch_parallel.py's world: the TP steps, the mesh
    trainer and, on two ranks, the fan-out and the collective rules."""
    out = {"tp": tp_steps(rank, world), "fits": trainer_fits(rank, world)}
    if world == 2:
        out["rules"] = world_grads_are_exact(rank, world)
    return out
