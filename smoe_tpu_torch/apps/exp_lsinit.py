"""The least-squares expert init (fit/lsinit.py) measured on the headline
bench geometry (from scripts/exp_lsinit.py): 512x512 RGB, K = 256
(bench/flagship.py).

For each variant (plain sample init, -lsinit, and with --refresh a
periodic kernel-mode LS refresh) runs the reference recipe fit and records
the PSNR trajectory, the iterations and seconds to the target and the cost
of the LS solve itself (cold, then warm).  Prints one line per variant and
one JSON line of all.

    python -m smoe_tpu_torch.apps.exp_lsinit [--size 512] [--target 32]
        [--max 2000] [--mode auto] [--refresh N] [--device cuda|cpu]

--cpu is the same as --device cpu.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common
from smoe_tpu_torch.bench.flagship import build_image, make_smoe, warm_chunk


def fit(s, target, max_iters, chunk=20, ls_every=0):
    from smoe_tpu_torch.core.losses import psnr_from_mse
    t0 = common.clock(s.device)
    iters, psnr, t_hit, i_hit = 0, 0.0, None, None
    traj = []
    while iters < max_iters:
        _, mse_a, _, _ = s.run_batched_chunk(chunk)
        iters += chunk
        if iters % 100 == 0:
            s.update_kernel_list()
        if ls_every and iters % ls_every == 0:
            s.ls_init_experts(mode="kernel")
        psnr = max(psnr, psnr_from_mse(np.nanmin(mse_a), s.cfg.precision))
        traj.append((iters, round(float(psnr), 2)))
        if t_hit is None and psnr >= target:
            t_hit, i_hit = common.clock(s.device) - t0, iters
            break
    return {"psnr": round(float(psnr), 2), "iters_to_target": i_hit,
            "t_to_target_s": round(t_hit, 3) if t_hit else None,
            "traj": traj[:5] + traj[5::5]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--target", type=float, default=32.0)
    ap.add_argument("--max", type=int, default=2000)
    ap.add_argument("--mode", type=str, default="auto")
    ap.add_argument("--refresh", type=int, default=0,
                    help="also run a variant with a periodic kernel-mode "
                         "LS refresh every N iters")
    add_device_arg(ap, cpu_flag=True)
    args = ap.parse_args(argv)
    device = device_of(args.device, args.cpu)
    from smoe_tpu_torch.core.losses import psnr_from_mse

    img = build_image(args.size)
    s = make_smoe(img, device)
    s.set_optimizer()
    warm_chunk(s, 20, rounds=2)

    out = {}
    variants = ["plain", "lsinit"] + \
        (["ls_refresh"] if args.refresh else [])
    for tag in variants:
        s.reinit()
        if tag != "plain":
            t0 = common.clock(device)
            s.ls_init_experts(mode=args.mode)
            t_solve_cold = common.clock(device) - t0
            s.reinit()
            t0 = common.clock(device)
            s.ls_init_experts(mode=args.mode)
            t_solve = common.clock(device) - t0
            out["ls_solve_s"] = round(t_solve, 3)
            out["ls_solve_cold_s"] = round(t_solve_cold, 3)
        _, m0, _, _ = s.run_batched(train=False)
        r = fit(s, args.target, args.max,
                ls_every=args.refresh if tag == "ls_refresh" else 0)
        r["init_psnr"] = round(float(psnr_from_mse(m0, s.cfg.precision)), 2)
        out[tag] = r
        print(tag, json.dumps(r), flush=True)
    out.update(common.card_fields(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
