"""The benchmark of smoe_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs one cell of BENCHMARK.json and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device and, with --trace 1, breakdown; the numbers that decided `correct`
come last, under "checks", and again as the last lines of standard error.

Everything is found by name.  A cell names a configuration, whose sizes
are `configs/<config>.json`, and a traffic mix, whose parameters are
`traffic/<traffic>.json`; the mix's `driver` names the module
`drivers/<driver>.py` that sets the system up, measures the window and
checks the output against `reference/`.  Each per-layer metric is read by
`metrics/<name>.py` from what the driver measured, and each cell's limits
are `limits/<cell>.json`.  A later cell, mix or metric is a new file.

A run refuses (exit 2, no result) without a CUDA card, or with fewer than
the cell asks for, and fails (exit 3, no result) if JAX or the JAX package
was loaded in its process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "smoe_tpu")


def load_module(path: str, name: str):
    """The module at `path` (a file of the benchmark, found by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (smoe_tpu_torch is not smoe_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def per_layer_for(bench: dict, cell: dict) -> list:
    """The per-layer metrics whose readers run in this cell."""
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def end_to_end_for(bench: dict, cell: dict) -> list:
    return [m for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides=None, bench=None) -> dict:
    """One run of a cell on `device`, without the look for a card: the
    result line as a dict.  `overrides` replaces keys of the
    configuration and the traffic mix (the tests' small sizes)."""
    bench = bench or read_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, cell_name)
    cfg = read_json(HERE, "configs", cell["config"] + ".json")
    traffic = read_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = read_json(HERE, "limits", cell["name"] + ".json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    driver = load_module(os.path.join(HERE, "drivers",
                                      traffic["driver"] + ".py"),
                         "bench_driver_" + traffic["driver"])
    ctx = dict(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed),
               seconds=float(seconds), trace=bool(trace), device=device,
               t_start=T_START, faults=overrides.get("faults", {}))
    m = driver.run(ctx)

    units = {x["name"]: x["unit"] for x in bench["end_to_end"]
             + bench["per_layer"]}
    metrics = {}
    if trace:
        for spec in per_layer_for(bench, cell):
            reader = load_module(os.path.join(HERE, "metrics",
                                              spec["name"] + ".py"),
                                 "bench_metric_" + spec["name"])
            v = reader.read(m)
            if v is not None:
                metrics[spec["name"]] = {"value": float(v),
                                         "unit": units[spec["name"]]}
    else:
        for spec in end_to_end_for(bench, cell):
            v = m["end_to_end"].get(spec["name"])
            if v is not None:
                metrics[spec["name"]] = {"value": float(v),
                                         "unit": units[spec["name"]]}
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in m["checks"].items()}
    correct = all(v == v and v <= limits[k] for k, v in m["checks"].items())
    out = {"correct": bool(correct and not m.get("failed")),
           "attempted": int(m["attempted"]), "failed": int(m["failed"]),
           "metrics": metrics, "device": m["device"]}
    if trace and m.get("breakdown"):
        out["breakdown"] = m["breakdown"]
    # the peaks the rooflines divide by assume the card's 700 W limit
    out["power_limit_w"] = m["power_limit_w"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = read_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
