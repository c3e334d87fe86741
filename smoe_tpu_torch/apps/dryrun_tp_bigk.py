"""Kernel-axis (TP) sharding at the K = 9216 scale (from
scripts/dryrun_tp_bigk.py): the regime where the capped-dense width
saturates one device and the 'k' mesh axis is the remaining lever.

Runs the full trainer (`Smoe(mesh=...)`: QAT 3, kernel lists,
regularizers) on a ('b', 'k') mesh over a world of processes
(parallel/launch.py:run_world, gloo) with the 4K bench's kernel capacity
(96 x 96 = 9216 kernels), takes real train steps, and prints the per-rank
kernel width (K / nk) of every kernel-indexed leaf.  Under a 'k' split the
trainer takes the plain path (K1 normalises inside the kernel and cannot
sum the denominator across ranks).

The image is spatially reduced, as in the JAX script: the point is the
capacity-axis sharding, each rank holding, differentiating and updating
only K / nk kernel rows, with the gating denominator, the expert partials
and the QAT-3 bounds as the only cross-rank traffic.

    python -m smoe_tpu_torch.apps.dryrun_tp_bigk [--k 96] [--size 256]
        [--nk 4] [--steps 2] [--world N] [--device cuda|cpu]

--world: the processes (default 8 on the CPU, the JAX script's virtual
devices; 2 on the card, all on cuda:0); nb = world // nk blocks of the
mesh's 'b' axis, nk defaults to min(4, world).
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common

LEAVES = ("pis", "musX", "nu_e", "gamma_e", "a_diag")


def build(size: int):
    """The script's reduced test image (dryrun_tp_bigk.py:62-67)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size] / (size - 1)
    img = np.stack([0.5 + 0.3 * np.sin(9 * x + 2 * y),
                    0.5 + 0.25 * np.cos(7 * x * y),
                    0.4 + 0.3 * np.sin(5 * (x + y))], -1).astype(np.float32)
    img += rng.normal(0, 0.005, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def rank_main(rank, world, k, size, nk, steps, on):
    """One rank of the world: the trainer on the ('b', 'k') mesh, `steps`
    sweeps on device `on`; its loss, mse, live kernels and per-leaf row
    counts."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from smoe_tpu_torch.fit.trainer import Smoe
    from smoe_tpu_torch.parallel.sharded import make_mesh
    nb = world // nk
    # normalize_pis=False: at K ~ 10^4 a normalized 1/K init sits below the
    # 10-bit pi quantization step (2/1023) and QAT would zero every kernel
    # at init; big-K runs start the pis at 1
    s = Smoe(build(size), kernels_per_dim=[k], start_batches=nb * 2,
             quantization_mode=3, normalize_pis=False, device=on,
             mesh=make_mesh(nb, nk, torch.device(on).type))
    s.set_optimizer()
    t0 = common.clock(on)
    loss, mse, npi, _ = s.run_batched_chunk(steps, pis_l1=1e-5, u_l1=1e-7)
    dt = common.clock(on) - t0
    return {"capacity": s.cfg.capacity, "blocks": s.start_batches,
            "loss": [float(v) for v in loss], "mse": [float(v) for v in mse],
            "live": int(npi[-1]), "seconds": dt,
            "widths": {name: int(getattr(s.params, name).shape[0])
                       for name in LEAVES}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=96,
                    help="kernels per dim (96 -> K=9216, the 4K bench)")
    ap.add_argument("--size", type=int, default=256,
                    help="image side (reduced)")
    ap.add_argument("--nk", type=int, default=None,
                    help="'k' mesh axis size (default min(4, world))")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--world", type=int, default=None,
                    help="processes (default 8 on the CPU, 2 on the card)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.parallel.launch import run_world

    world = args.world or (2 if common.platform(device) == "gpu" else 8)
    nk = args.nk or min(4, world)
    if world % nk:
        raise SystemExit(f"--nk {nk} does not divide the world of {world}")
    nb = world // nk
    with tempfile.TemporaryDirectory(prefix="smoe_tp_bigk_") as wd:
        ranks = run_world("smoe_tpu_torch.apps.dryrun_tp_bigk:rank_main",
                          world, wd, device=device, timeout=1800, k=args.k,
                          size=args.size, nk=nk, steps=args.steps,
                          on=device)
    r0 = ranks[0]
    K = r0["capacity"]
    print(f"mesh=({nb}b x {nk}k)  K={K}  blocks={r0['blocks']}  "
          f"image={(args.size, args.size, 3)}  world={world} on {device}")
    for r in ranks:
        bad = {n: w for n, w in r["widths"].items() if w != K // nk}
        assert not bad, f"shards {bad}, want {K // nk}"
        assert np.isfinite(r["loss"]).all()
    print(f"per-rank kernel width: {K}//{nk} = {K // nk}  "
          f"(verified on {list(LEAVES)})")
    print(f"{args.steps} steps: loss {r0['loss'][0]:.5f} -> "
          f"{r0['loss'][-1]:.5f}, mse {r0['mse'][-1]:.1f}, live kernels "
          f"{r0['live']}, {max(r['seconds'] for r in ranks):.1f}s wall "
          f"(the slowest rank)")
    out = {"metric": "tp_bigk_dryrun", "mesh": [nb, nk], "world": world,
           "kernels": K, "blocks": r0["blocks"], "steps": args.steps,
           "per_rank_widths": [r["widths"] for r in ranks],
           "loss": r0["loss"], "mse": r0["mse"], "live_kernels": r0["live"],
           "s_per_step": max(r["seconds"] for r in ranks) / args.steps,
           **common.card_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
