"""End-to-end times of the PyTorch port on one NVIDIA GPU, host clock, to
compare two trees of the repo on the same card.

    python3 scripts/time_torch_e2e.py [--root DIR] [flagship] [1080p]
        [decode512] [decode4k]

Imports `smoe_tpu_torch` from DIR (default: this checkout), so the same
script times an earlier commit unpacked with `git archive`.

  flagship, 1080p: the bench flagship fit (bench.py:46-54; 512^2 RGB,
    16x16 kernels, one block) and the 1080p fit (scripts/bench_1080p.py:40;
    24x24 kernels, 16 blocks): the lists and the capped width settle over
    two chunks of 20 sweeps, then three chunks (100 sweeps at the flagship,
    20 at 1080p), each ending in its one metrics pull, are timed: s/iter.
  decode512, decode4k: `decode_bitstream(path, device="cuda")`, file to
    numpy image, of the committed fixture tests/data/bench512_k256.smoe and
    of chip_smoke.py's 4K x 2304-kernel model (phase 7, written by this
    checkout): median of 5 after a warm-up, beside `read_model` alone.
Prints one JSON line per configuration with the root and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = ("flagship", "1080p", "decode512", "decode4k")


def host_ms_median(fn, reps=5):
    import torch
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out


def time_decode(path):
    from smoe_tpu_torch.codec.serve import decode_bitstream, read_model
    e2e, runs = host_ms_median(lambda: decode_bitstream(path, device="cuda"))
    return {"decode_e2e_ms_median": e2e, "decode_e2e_ms": runs,
            "read_model_ms_median": host_ms_median(
                lambda: read_model(path))[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", metavar="{" + ",".join(CONFIGS)
                   + "}", default=list(CONFIGS))
    p.add_argument("--root", default=os.path.dirname(HERE),
                   help="the tree whose smoe_tpu_torch is timed")
    a = p.parse_args(argv)
    bad = set(a.configs) - set(CONFIGS)
    if bad:
        p.error(f"unknown configuration {sorted(bad)}")
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("time_torch_e2e: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from smoe_tpu_torch.fit.trainer import Smoe
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    spec = importlib.util.spec_from_file_location(
        "bench_1080p", os.path.join(HERE, "bench_1080p.py"))
    b1080 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(b1080)
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(HERE), "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for config in a.configs:
        if config.startswith("decode"):
            if config == "decode512":
                out = time_decode(os.path.join(os.path.dirname(HERE),
                                               "tests", "data",
                                               "bench512_k256.smoe"))
            else:
                import tempfile
                sys.path.insert(1, os.path.dirname(HERE))
                import chip_smoke
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "uhd_k2304.smoe")
                    chip_smoke.write_uhd_model(path)
                    out = time_decode(path)
            print(json.dumps({"root": root, "config": config, **out,
                              "card": card}), flush=True)
            continue
        if config == "flagship":
            s = Smoe(bench.build_image(512), kernels_per_dim=[16],
                     use_yuv=True, use_determinant=True, device="cuda")
            sweeps = 100
        else:
            s = Smoe(b1080.build_1080p(), kernels_per_dim=[24, 24],
                     batch_size=(270, 480), use_yuv=True,
                     use_determinant=True, device="cuda")
            sweeps = 20
        s.set_optimizer()
        s.run_batched_chunk(20)
        s.run_batched_chunk(20)
        per_iter = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_batched_chunk(sweeps)
            torch.cuda.synchronize()
            per_iter.append((time.perf_counter() - t0) / sweeps)
        print(json.dumps({"root": root, "config": config, "sweeps": sweeps,
                          "s_per_iter": per_iter,
                          "s_per_iter_median": statistics.median(per_iter),
                          "card": card}), flush=True)
        del s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
