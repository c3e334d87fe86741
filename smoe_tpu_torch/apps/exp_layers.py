"""Layered (SNR-scalable) bitstream study (from scripts/exp_layers.py):
the rate and quality of tier-prefix decodes from one file.

Fits a structured image, writes the quantized model flat (v3) and layered
(v4, write_bitstream layers=L), then decodes every tier prefix of the
layered file and reports the cumulative rate and PSNR per prefix: the
graceful-degradation curve a progressive transmission sees.  Also measures
the layering overhead (independent per-tier coders re-learn their adaptive
contexts) and the value of the importance ordering (the analytic
gating-mass ordering against a seeded random one).

    python -m smoe_tpu_torch.apps.exp_layers [--size 192] [--iters 500]
        [--k 10] [--layers 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of


def trainer(img, k: int, device, **cfg):
    """The fit's trainer after its LS expert init, ready for its first
    sweep."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(img, kernels_per_dim=[k], use_yuv=True, use_determinant=True,
             normalize_pis=False, device=device, **cfg)
    s.set_optimizer()
    s.ls_init_experts()
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--layers", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    from smoe_tpu_torch.apps.content import build_image
    from smoe_tpu_torch.codec.bitstream import (kernel_importance,
                                                read_bitstream,
                                                write_bitstream)
    from smoe_tpu_torch.codec.quantize import quantize_params, rate_bits
    from smoe_tpu_torch.codec.serve import decode_bitstream

    img = build_image(args.size)
    s = trainer(img, args.k, device)
    s.train(args.iters, val_iter=max(args.iters // 5, 1), ukl_iter=100)
    q = quantize_params(s.get_best_params(), s.cfg)
    k = int(np.count_nonzero(np.asarray(q["used_kernels"], bool)))
    extra = {"shape_of_img": list(img.shape[:-1]),
             "dim_of_output": img.shape[-1],
             "use_yuv": s.cfg.use_yuv,
             "use_determinant": s.cfg.use_determinant}

    def psnr(rec):
        mse = float(np.mean((np.asarray(rec) - img) ** 2)) * 255.0 ** 2
        return 10 * np.log10(255.0 ** 2 / mse)

    def decode(path, **kw):
        return decode_bitstream(path, device=device, **kw)

    with tempfile.TemporaryDirectory(prefix="smoe_layers_") as tmp:
        flat = os.path.join(tmp, "flat.smoe")
        bits_flat = write_bitstream(flat, q, s.cfg, extra=extra)
        flat_rec = decode(flat)

        n_pix = float(np.prod(img.shape[:-1]))
        results = {"metric": "layered_bitstream_study",
                   "size": args.size, "kernels_live": k,
                   "layers": args.layers,
                   "flat_bits": bits_flat, "flat_bpp": bits_flat / n_pix,
                   "flat_psnr_db": round(psnr(flat_rec), 2),
                   "raw_proxy_bits": rate_bits(q, s.cfg)}

        for label, imp in (
                ("importance", None),
                ("random", np.random.default_rng(3).permutation(k).astype(
                    np.float64))):
            path = os.path.join(tmp, f"lay_{label}.smoe")
            bits = write_bitstream(path, q, s.cfg, extra=extra,
                                   layers=args.layers, importance=imp)
            _, header = read_bitstream(path, max_layers=1)
            header_bytes = os.path.getsize(path) - sum(
                int(lh["bytes"]) for lh in header["layers"])
            rows = []
            cum = header_bytes * 8
            for m in range(1, args.layers + 1):
                cum += int(header["layers"][m - 1]["bytes"]) * 8
                rec = decode(path, layers=m)
                _, hm = read_bitstream(path, max_layers=m)
                rows.append({"tiers": m,
                             "kernels": int(hm["num_kernels"]),
                             "cum_bits": cum, "cum_bpp": cum / n_pix,
                             "psnr_db": round(psnr(rec), 2)})
            results[label] = rows
            results[f"{label}_total_bits"] = bits
            results[f"{label}_overhead_pct"] = round(
                100.0 * (bits - bits_flat) / bits_flat, 2)

        # the full layered decode equals the flat decode exactly
        full = decode(os.path.join(tmp, "lay_importance.smoe"))
        if not np.array_equal(full, flat_rec):
            raise RuntimeError("full layered decode must equal the flat "
                               "decode")
    imp_vals = kernel_importance(q, s.cfg)
    results["importance_spread"] = round(
        float(imp_vals.max() / max(imp_vals.min(), 1e-12)), 1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
