"""Config-5 capability check (from scripts/bench_video.py:97-138): the
video volume fit with 3D spatio-temporal kernels and global-motion
compensation.

The synthetic CIF panning clip (apps/content.py:build_video, known affine
ground truth) fit with the dual-model affine init, [12, 12, 4] kernels:
20 sweeps, 100-sweep chunks until the capped width settles, one timed
chunk of 100, then 3 chunks with `update_kernel_list`.  Prints one JSON
line with the script's keys and the card's name and power limit.

    python -m smoe_tpu_torch.bench.video [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, content, device_of
from smoe_tpu_torch.bench import common


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.fit.trainer import Smoe

    vid, affines = content.build_video()
    t0 = common.clock(device)
    s = Smoe(vid, kernels_per_dim=[12, 12, 4], affines=affines,
             init_flag=1, use_yuv=True, use_determinant=True, device=device)
    s.set_optimizer()
    s.run_batched_chunk(20)
    compile_s = common.clock(device) - t0

    # time the 100-sweep chunk at the SETTLED cap (the width tightens
    # after each chunk; stop when it stops changing)
    best = 0.0
    prev = object()
    for _ in range(4):
        loss, mse, npi, _ = s.run_batched_chunk(100)
        best = max(best, psnr_from_mse(float(np.nanmin(mse)), 8))
        cap = s._current_k_cap()
        if cap == prev:
            break
        prev = cap
    t0 = common.clock(device)
    loss, mse, npi, _ = s.run_batched_chunk(100)
    per_iter = (common.clock(device) - t0) / 100
    best = max(best, psnr_from_mse(float(np.nanmin(mse)), 8))
    for _ in range(3):
        loss, mse, npi, _ = s.run_batched_chunk(100)
        s.update_kernel_list()
        best = max(best, psnr_from_mse(float(np.nanmin(mse)), 8))

    out = {
        "metric": "video_cif_fit_ms_per_iter",
        "value": round(per_iter * 1000, 3),
        "unit": "ms",
        "frames": vid.shape[2],
        "kernels_live": int(npi[-1]),
        "dual_model": s.model_mask is not None,
        "psnr_500_iters": round(float(best), 2),
        "compile_s": round(compile_s, 1),
        **common.card_fields(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
