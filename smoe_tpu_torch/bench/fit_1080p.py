"""Config-3 capability check (from scripts/bench_1080p.py): the
block-partitioned 1080p fit.

Measures steady-state ms/iter and the PSNR trajectory of a 1920x1080 RGB
fit with 16 spatial blocks of 270x480 and per-block kernel lists: 20
sweeps, then 100, then 4 chunks of 100, each followed by
`update_kernel_list`.  Prints one JSON line with the script's keys and the
card's name and power limit.

    python -m smoe_tpu_torch.bench.fit_1080p [k] [mode] [--device cuda|cpu]

k: kernels per dim (default 24); mode: use_pallas, `auto` / `on` / `off`
(core/model.py:resolve_fused; default auto).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.apps.content import build_1080p
from smoe_tpu_torch.bench import common


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("k", type=int, nargs="?", default=24)
    ap.add_argument("mode", type=str, nargs="?", default="auto")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.fit.trainer import Smoe

    img = build_1080p()
    k, mode = args.k, args.mode
    s = Smoe(img, kernels_per_dim=[k, k], batch_size=(270, 480),
             use_yuv=True, use_determinant=True, use_pallas=mode,
             device=device)
    B = s.start_batches
    t0 = common.clock(device)
    s.set_optimizer()
    s.run_batched_chunk(20)
    compile_s = common.clock(device) - t0

    t0 = common.clock(device)
    loss, mse, npi, _ = s.run_batched_chunk(100)
    per_iter = (common.clock(device) - t0) / 100
    s.update_kernel_list()
    best = 10 * np.log10(255 ** 2 / np.nanmin(mse))
    chunk_ms = [round(per_iter * 1000, 2)]
    for _ in range(4):
        t0 = common.clock(device)
        loss, mse, npi, _ = s.run_batched_chunk(100)
        chunk_ms.append(round((common.clock(device) - t0) * 10, 2))
        s.update_kernel_list()
        best = max(best, 10 * np.log10(255 ** 2 / np.nanmin(mse)))

    klist = s.kernel_lists.float().cpu().numpy()
    active_frac = float(klist.mean())
    out = {
        "metric": "1080p_block_fit_ms_per_iter",
        "value": min(chunk_ms),
        "unit": "ms",
        "chunk_ms": chunk_ms,
        "mode": mode,
        "blocks": B,
        "kernels": k * k,
        "psnr_500_iters": round(float(best), 2),
        "kernel_list_active_frac": round(active_frac, 3),
        "compile_s": round(compile_s, 1),
        "pixel_kernel_pairs_per_iter":
            int(img.shape[0] * img.shape[1]) * k * k,
        **common.card_fields(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
