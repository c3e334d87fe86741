"""4K scaling check (from scripts/bench_4k.py): 3840x2160 RGB, a blocked
fit with capped-dense kernel lists, 48x48 = 2304 kernels in 32 blocks of
540x480 at the probe threshold `thr`.

20 sweeps, then 3 chunks of 100, each followed by `update_kernel_list`.
Prints one JSON line with the script's keys and the card's name and power
limit.

    python -m smoe_tpu_torch.bench.fit_4k [thr] [k] [--packed]
        [--device cuda|cpu]

thr: probe maha threshold (default 800); k: kernels per dim (default 48).
--packed asks for the in-kernel tile-culling path, which the JAX package
removed: it raises resolve_fused's ValueError, as the JAX trainer raises
(smoe_tpu/fit/trainer.py:356-366).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.apps.content import build_4k
from smoe_tpu_torch.bench import common


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("thr", type=float, nargs="?", default=800.0)
    ap.add_argument("k", type=int, nargs="?", default=48)
    ap.add_argument("--packed", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.fit.trainer import Smoe

    thr, k, packed = args.thr, args.k, args.packed
    img = build_4k()
    t0 = common.clock(device)
    s = Smoe(img, kernels_per_dim=[k, k], batch_size=(540, 480),
             use_yuv=True, use_determinant=True, probe_maha_threshold=thr,
             use_pallas="packed" if packed else "auto", device=device)
    s.set_optimizer()
    s.run_batched_chunk(20)
    compile_s = common.clock(device) - t0
    best = 0.0
    times = []
    for _ in range(3):
        t0 = common.clock(device)
        _, mse, npi, _ = s.run_batched_chunk(100)
        times.append((common.clock(device) - t0) / 100)
        s.update_kernel_list()
        best = max(best, psnr_from_mse(float(np.nanmin(mse)), 8))
    out = {
        "metric": "4k_block_fit_ms_per_iter",
        "value": round(min(times) * 1000, 2),
        "unit": "ms", "thr": thr, "blocks": s.start_batches,
        "kernels": k * k,
        "chunk_ms": [round(t * 1000, 2) for t in times],
        "psnr_300": round(float(best), 2), "compile_s": round(compile_s, 1),
        "pallas": "packed" if packed else "auto",
        "density": round(float(s.kernel_lists.float().mean()), 3),
        **common.card_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
