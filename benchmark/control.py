"""The readings the limits of `correct` are set from, on the card at a
cell's own size (the benchmark's own runs never run this).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        --mode sound|control|frozen|half|stale|altered [--seconds 3]

sound    the benchmark's run of the cell (a short window), its numbers;
control  the reference computed in TF32 (each contraction's operands
         rounded to a 10-bit mantissa) put in the program's place, held
         to the float32 reference by the same comparison;
frozen, half (fit cells), stale, altered (decode cells): the benchmark's
         run with the fault planted under the timed path (a step that
         returns its state unchanged; half of each block's pixels left out,
         the mean taken over the rest; the previous request's image
         returned; one row of the image zeroed).

Prints one JSON line a seed: the numbers, their limits and `correct`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402

FAULTS = {"frozen": {"frozen": 1}, "half": {"half": 1},
          "stale": {"stale": 1}, "altered": {"altered": 1}}


def control_checks(cell_name: str, seed: int, device, overrides=None):
    """The control's numbers: the TF32 reference in the program's place."""
    import torch
    bench = run.read_json(run.ROOT, "BENCHMARK.json")
    cell = run.find_cell(bench, cell_name)
    cfg = run.read_json(HERE, "configs", cell["config"] + ".json")
    mix = run.read_json(HERE, "traffic", cell["traffic"] + ".json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    mix.update(overrides.get("traffic", {}))
    driver = run.load_module(os.path.join(HERE, "drivers",
                                          mix["driver"] + ".py"),
                             "bench_driver_" + mix["driver"])
    ctx = dict(cell=cell, cfg=cfg, traffic=mix, seed=seed, seconds=0.0,
               trace=False, device=device, faults={})
    torch.backends.cuda.matmul.allow_tf32 = False
    if mix["driver"] == "fit":
        from yardstick import content
        from reference import smoe_ref as R
        image = content.build(cfg["content"], seed)
        init = R.grid_init(image, int(cfg["kernels_per_dim"]))
        block = tuple(cfg["block_shape"]) if cfg.get("block_shape") \
            else image.shape[:2]
        rec = driver.reference_record(ctx, image, block, init, "tf32")
        return driver.check(ctx, image, block, init, rec, "fp32")
    from reference import quantize_ref as Q
    from reference import smoe_ref as R
    params, shape = driver.pool_params(cfg, seed, int(mix["pool_files"]))
    qcfg = Q.codec_cfg(**cfg["codec"])
    low = R.Ref({"precision": int(cfg["precision"]), "use_yuv": cfg["use_yuv"],
                 "use_determinant": cfg["use_determinant"]}, "tf32")
    kept = {}
    for f, p in enumerate(params):
        dq = Q.rescaler(Q.quantize_params(p, qcfg), qcfg)
        kept[f] = (f, R.decode(low, dq, shape[:2], device).cpu().numpy())
    return driver.check(ctx, params, shape[:2], kept, "fp32")[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=["sound", "control"] + sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = args.workload
    limits = run.read_json(HERE, "limits", cell + ".json")
    for seed in [int(s) for s in args.seeds.split(",")]:
        extra = {}
        if args.mode == "control":
            checks = control_checks(cell, seed, args.device)
        else:
            out = run.run_cell(cell, seed, args.seconds, False,
                               device=args.device,
                               overrides={"faults": FAULTS.get(args.mode,
                                                               {})})
            checks = {k: v["value"] for k, v in out["checks"].items()}
            extra = {k: v["value"] for k, v in out["metrics"].items()}
        correct = all(v == v and v <= limits[k] for k, v in checks.items())
        print(json.dumps({"workload": cell, "mode": args.mode, "seed": seed,
                          "checks": checks, "limits": limits,
                          "correct": correct, "metrics": extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
