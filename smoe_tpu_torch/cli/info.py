"""Inspect a `.smoe` bitstream: container metadata, rate, tier table,
and an optional per-group coded-bits breakdown.

A copy of smoe_tpu/cli/info.py with its imports pointed into the port
(host-only, no device code).

No reference analog — the reference's "bitstream" is an opaque pickle
(smoe_reconstruction_decoded.py:18-19); an operator debugging a rate
regression or a serving decision needs this at a glance.

    python -m smoe_tpu_torch.cli.info model.smoe [--breakdown]

Header-only by default (no entropy decode — works on files whose
payload is large or truncated); --breakdown entropy-decodes the payload
and re-codes each param stream standalone to attribute its cost.
"""

import argparse
import os


def main(args=None):
    p = argparse.ArgumentParser(
        prog="smoe_tpu_torch.cli.info",
        description="inspect a .smoe bitstream (header metadata, rate, "
                    "tiers; --breakdown for per-group coded bits)")
    p.add_argument("path", help=".smoe file")
    p.add_argument("--breakdown", action="store_true",
                   help="entropy-decode and attribute coded bits per "
                        "param group (codec.bitstream.rate_breakdown)")
    a = p.parse_args(args)

    import numpy as np

    from smoe_tpu_torch.codec.bitstream import read_header

    h = read_header(a.path)
    fsize = os.path.getsize(a.path)
    shape = h.get("shape_of_img")
    n_pix = int(np.prod(shape)) if shape else None
    lines = [
        f"container      v{h['version']}"
        + ("  (SNR-scalable layered)" if "layers" in h else ""),
        f"file           {fsize} bytes",
        f"model          {h['num_kernels']} kernels used / "
        f"{h['num_slots']} slots, d={h['dim_domain']}, "
        f"precision {h['precision']} bit",
        f"bit depths     [A:{h['bit_depths'][0]} mu:{h['bit_depths'][1]} "
        f"nu:{h['bit_depths'][2]} pi:{h['bit_depths'][3]} "
        f"gamma:{h['bit_depths'][4]}]",
        "flags          " + ", ".join(
            k for k in ("use_yuv", "use_determinant", "use_diff_center",
                        "radial_as", "train_inverse_cov", "train_gammas")
            if h.get(k)),
    ]
    if shape:
        lines.append(f"output         {'x'.join(str(s) for s in shape)} "
                     f"x {int(np.ravel(h.get('dim_of_output', [3]))[0])}ch")
    if h.get("motion") is not None:
        lines.append(f"video motion   {h['num_params_model']}-param model, "
                     f"{h['num_frames']} frames"
                     + (", dual-model ({} transformed / {} raw)".format(
                         int(np.sum(h["model_mask"])),
                         int(len(h["model_mask"])
                             - np.sum(h["model_mask"])))
                        if h.get("model_mask") is not None else ""))
    if "layers" in h:
        hdr_bytes = 8 + (fsize - 8
                         - sum(int(lh["bytes"]) for lh in h["layers"]))
        cum = hdr_bytes
        lines.append("tiers          kernels    bytes  cum_bytes"
                     + ("    cum_bpp" if n_pix else ""))
        for i, lh in enumerate(h["layers"]):
            cum += int(lh["bytes"])
            lines.append(
                f"  tier {i + 1:<8}{int(lh['num_kernels']):>7}"
                f"{int(lh['bytes']):>9}{cum:>11}"
                + (f"{8 * cum / n_pix:>11.4f}" if n_pix else ""))
    else:
        # payload = file minus container prefix (MAGIC + u32 + header)
        with open(a.path, "rb") as fd:
            import struct
            fd.read(4)
            hlen = struct.unpack("<I", fd.read(4))[0]
        pay_bits = (fsize - 8 - hlen) * 8
        lines.append(f"rate           {pay_bits} payload bits"
                     + (f", {pay_bits / n_pix:.4f} bpp" if n_pix else ""))
    print("\n".join(lines))

    if a.breakdown:
        from smoe_tpu_torch.codec.bitstream import (rate_breakdown,
                                                     read_bitstream)
        from smoe_tpu_torch.config import SmoeConfig
        qp, hdr = read_bitstream(a.path)
        cfg = SmoeConfig(
            dim_domain=int(hdr["dim_domain"]),
            num_channels=int(np.ravel(hdr.get("dim_of_output", [3]))[0]),
            kernels_per_dim=tuple(hdr["kernels_per_dim"]),
            precision=int(hdr.get("precision", 8)),
            bit_depths=tuple(hdr["bit_depths"]),
            use_diff_center=bool(hdr.get("use_diff_center", False)),
            radial_as=bool(hdr.get("radial_as", False)),
            train_inverse_cov=bool(hdr.get("train_inverse_cov", False)))
        bk = rate_breakdown(qp, cfg)
        total = bk["_total"]["bits"]
        print("breakdown      (standalone-coder attribution)")
        for name, v in sorted(
                ((k, v) for k, v in bk.items() if k != "_total"),
                key=lambda kv: -kv[1]["bits"]):
            print(f"  {name:<13}{v['bits']:>9} bits  "
                  f"{100 * v['bits'] / max(total, 1):5.1f}%  "
                  f"({v['raw_bits']} raw, mode {v['mode']})")
        print(f"  total        {total:>9} bits  ({bk['_total']['raw_bits']}"
              " raw)")
    return h


if __name__ == "__main__":
    main()
