"""The readings the video cell's limits of `correct` are set from, on the
card at the cell's own size (the benchmark's own runs never run this).

    python3 benchmark/control_video.py --workload video_cif.fit
        --seeds 1,2,3 --mode sound|control|frozen|half [--seconds 3]

sound    the benchmark's run of the cell (a short window), its numbers;
control  the run with each checked stage made by the reference computed
         in TF32 (each contraction's operands rounded to a 10-bit
         mantissa) from the program's state, held to the float32
         reference by the same comparison (drivers/fit_video.py:
         control_checks);
frozen, half: the benchmark's run with the fault planted under the timed
         path (a step that returns its state unchanged; half of each
         block's pixels left out, the mean taken over the rest).

Prints one JSON line a seed: the numbers, their limits and `correct`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import control  # noqa: E402
import run  # noqa: E402

FAULTS = {k: control.FAULTS[k] for k in ("frozen", "half")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="video_cif.fit")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=["sound", "control"] + sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = args.workload
    limits = run.read_json(HERE, "limits", cell + ".json")
    driver = run.load_module(os.path.join(HERE, "drivers", "fit_video.py"),
                             "bench_driver_fit_video")
    for seed in [int(s) for s in args.seeds.split(",")]:
        extra = {}
        if args.mode == "control":
            checks = driver.control_checks(cell, seed, args.device,
                                           seconds=args.seconds)
        else:
            out = run.run_cell(cell, seed, args.seconds, False,
                               device=args.device,
                               overrides={"faults": FAULTS.get(args.mode,
                                                               {})})
            checks = {k: v["value"] for k, v in out["checks"].items()}
            extra = {k: v["value"] for k, v in out["metrics"].items()}
            extra["memory_peak_bytes"] = out["device"]["memory_peak_bytes"]
        correct = all(v == v and v <= limits[k] for k, v in checks.items())
        print(json.dumps({"workload": cell, "mode": args.mode, "seed": seed,
                          "checks": checks, "limits": limits,
                          "correct": correct, "metrics": extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
