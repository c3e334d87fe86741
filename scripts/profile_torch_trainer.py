"""Where a training sweep of the PyTorch port spends its time on the card.

    python scripts/profile_torch_trainer.py [flagship|1080p] [--sweeps 20]
        [--root DIR]

Fits the bench flagship (bench.py:46-54; 512^2 RGB, 16x16 kernels, one
block) or the 1080p configuration (scripts/bench_1080p.py:40; 24x24
kernels, 16 blocks) on the first GPU, settles the kernel lists and the
capped width over 40 sweeps, then traces one chunk of sweeps with
torch.profiler.  Prints one JSON line: the chunk's wall time per sweep,
the card's kernel time per sweep (the sum of the device time of every
kernel launched), the device busy share (kernel time / wall time), the
number of kernel launches per sweep and the top kernels by device time.
With --trace FILE, writes the Chrome trace there (tens of MB at 1080p).
With --root DIR, profiles the smoe_tpu_torch of another tree (an earlier
commit unpacked with `git archive`), to compare two trees on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="flagship",
                   choices=("flagship", "1080p"))
    p.add_argument("--sweeps", type=int, default=20)
    p.add_argument("--trace", metavar="FILE")
    p.add_argument("--root", default=ROOT,
                   help="the tree whose smoe_tpu_torch is profiled")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("profile_torch_trainer: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from smoe_tpu_torch.fit.trainer import Smoe

    if a.config == "flagship":
        from bench import build_image
        s = Smoe(build_image(512), kernels_per_dim=[16], use_yuv=True,
                 use_determinant=True, device="cuda")
    else:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "bench_1080p", os.path.join(ROOT, "scripts", "bench_1080p.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        s = Smoe(mod.build_1080p(), kernels_per_dim=[24, 24],
                 batch_size=(270, 480), use_yuv=True, use_determinant=True,
                 device="cuda")
    s.set_optimizer()
    s.run_batched_chunk(20)
    s.run_batched_chunk(20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.run_batched_chunk(a.sweeps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events, without the optimizer's user-annotation range
    # (it spans kernels that are counted on their own)
    events = [e for e in prof.key_averages()
              if not e.key.startswith("Optimizer.")]
    kernels = [e for e in events if "CUDA" in str(getattr(
        e, "device_type", "")) and dev_us(e) > 0]
    if not kernels:
        # kernels attributed to the host ops that launched them
        kernels = [e for e in events if dev_us(e) > 0]
    dev_total = sum(dev_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    out = {"config": a.config, "root": os.path.abspath(a.root),
           "card": torch.cuda.get_device_name(0),
           "sweeps": a.sweeps, "k_cap": s._current_k_cap(),
           "wall_ms_per_sweep": wall / a.sweeps * 1e3,
           "kernel_ms_per_sweep": dev_total / a.sweeps * 1e3,
           "device_busy_share": dev_total / wall,
           "kernel_launches_per_sweep": launches / a.sweeps,
           "top_kernels_ms_per_sweep": {
               e.key[:60]: dev_us(e) / 1e3 / a.sweeps for e in top}}
    print(json.dumps(out))
    if a.trace:
        prof.export_chrome_trace(a.trace)


if __name__ == "__main__":
    main()
