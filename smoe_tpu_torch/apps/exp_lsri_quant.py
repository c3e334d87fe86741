"""The LS refresh against the quantizer on the RD geometry (from
scripts/exp_lsri_quant.py): 256^2, K = 144.

Separates the candidate causes of a collapsed quantized PSNR under the
periodic LS expert refresh (`-lsri`):

  (a) in-list illusion: float in-list PSNR >> float dense PSNR;
  (b) quantizer-range stretch: float dense PSNR fine, qpsnr collapsed, the
      params' min/max ranges (the data-derived quantizer bounds) blown up
      by the LS experts;
  (c) a genuine float regression: float dense PSNR below the plain fit's.

The JAX study resolved it as (b), through the origin-anchored nu: LS fits
steep slopes, and nu extrapolated to x = 0 stretches the 6-bit nu
quantizer; the fix is the center-anchored nu coding (config.nu_anchor).
Each --damps value runs with the anchor off and on, beside the plain fit.

    python -m smoe_tpu_torch.apps.exp_lsri_quant [--iters 1000]
        [--size 256] [--lsri 100] [--damps 0 1e-2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common


def dense_eval_psnr(s):
    """Float PSNR with every kernel listed for every block (no list
    bias)."""
    import torch
    from smoe_tpu_torch.core.losses import psnr_from_mse
    saved = s.kernel_lists
    s.kernel_lists = torch.ones_like(saved)
    try:
        _, mse, _, _ = s.run_batched(train=False)
        return float(psnr_from_mse(mse, s.cfg.precision))
    finally:
        s.kernel_lists = saved
        s.valid = False


def run_variant(img, precision, iters, ls_every, device, damp=0.0,
                anchor=False):
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.fit.trainer import Smoe

    s = Smoe(img, kernels_per_dim=[12], use_yuv=True, precision=precision,
             nu_anchor=anchor, device=device)
    s.set_optimizer()
    if ls_every:
        s.ls_init_experts(mode="kernel", damp=damp)
    done = 0
    while done < iters:
        n = min(100, iters - done)
        _, mse_list, _, _ = s.run_batched_chunk(n)
        s.update_kernel_list()
        done += n
        if ls_every and done % ls_every == 0 and done < iters:
            s.ls_init_experts(mode="kernel", damp=damp)
    inlist = float(psnr_from_mse(np.nanmin(mse_list), precision))
    dense = dense_eval_psnr(s)
    s.qparams = quantize_params(s.get_params(), s.cfg)
    s.rparams = rescaler(s.qparams, s.cfg)
    _, qmse, _, _ = s.run_batched(train=False, update_reconstruction=True,
                                  with_quantized_params=True)
    qpsnr = float(psnr_from_mse(qmse, precision))
    p = s.get_params()
    # by name, as the JAX script prints them (jax.device_get sorts a
    # dict's keys)
    ranges = {name: [round(float(np.min(v)), 3), round(float(np.max(v)), 3)]
              for name, v in sorted(p.items())
              if hasattr(v, "size") and np.asarray(v).size}
    return {"float_inlist_db": round(inlist, 2),
            "float_dense_db": round(dense, 2),
            "qpsnr_db": round(qpsnr, 2), "ranges": ranges}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lsri", type=int, default=100)
    ap.add_argument("--damps", type=float, nargs="*", default=[0.0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.apps.content import build_image

    img = build_image(args.size)
    out = {"plain": run_variant(img, 8, args.iters, 0, device)}
    print("plain", json.dumps(out["plain"]), flush=True)
    for damp in args.damps:
        for anchor in (False, True):
            tag = f"lsri_damp{damp:g}" + ("_anchor" if anchor else "")
            out[tag] = run_variant(img, 8, args.iters, args.lsri, device,
                                   damp, anchor)
            print(tag, json.dumps(out[tag]), flush=True)
    out = {"metric": "lsri_quant_diag", **out, **common.card_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
