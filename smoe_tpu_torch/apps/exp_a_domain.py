"""Codec RD study (from scripts/exp_a_domain.py): the steering domain and
the bit allocation, measured through the production codec
(quantize_params -> write_bitstream -> rescaler -> serving decode) on a
converged 2D model, a float-params pickle or a .smoe file:

  1. the float-params PSNR (the quantization-free ceiling);
  2. sign canonicalization: flipping steering columns to a positive
     diagonal is free for the quadratic form (A A^T) but changes the sign
     of the determinant normalizer of the gating, so a kernel trained into
     prod(diag A) < 0 is fragile under quantization;
  3. the quantization loss per group: the decoded PSNR with one group held
     at float and the rest at the reference depths;
  4. the A domain at matched PSNR: linear at b bits against (log-eig,
     angle) at bl / bt bits, with real coded bits through the range coder
     (native/rangecoder.cc);
  5. the allocation of the other groups around the reference depths
     [A:20, mu:18, nu:6, pi:10, g:10].

    python -m smoe_tpu_torch.apps.exp_a_domain MODEL [--size 256]
        [--device cuda|cpu]

MODEL: a pickle of {"params": numpy dict (Smoe.get_params), "cfg":
SmoeConfig}, written by either package (a JAX pickle's config loads as the
port's copy, without jax), or a .smoe file.  The target image is
bench/flagship.py's build_image(--size).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import tempfile

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of
from smoe_tpu_torch.bench import common
from smoe_tpu_torch.codec.bitstream import (_causal_nbr, _delta_encode,
                                            _est_bits, _nbr_encode, _zigzag,
                                            encode_symbols, read_bitstream,
                                            write_bitstream)
from smoe_tpu_torch.codec.quantize import (RANGE_EPS, quantize_params,
                                           rescaler)

KERNEL_FIELDS = ("pis", "musX", "nu_e", "gamma_e", "A_diagonal", "A_corr")


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's SmoeConfig as the port's copy, whose fields
    are the same, so a JAX-written pickle loads without jax."""

    def find_class(self, module, name):
        if module == "smoe_tpu.config":
            module = "smoe_tpu_torch.config"
        return super().find_class(module, name)


def load_fit(path: str):
    """(params numpy dict, SmoeConfig) of a {"params", "cfg"} pickle."""
    with open(path, "rb") as f:
        blob = _Unpickler(f).load()
    return blob["params"], blob["cfg"]


def eig_of_A(A):
    """(K,2,2) steering factor -> (log l1, log l2, theta) of M = A A^T."""
    M = A @ np.swapaxes(A, 1, 2)
    a, b, c = M[:, 0, 0], M[:, 1, 1], M[:, 0, 1]
    disc = np.sqrt(np.maximum((a - b) ** 2 / 4 + c * c, 0.0))
    l1 = (a + b) / 2 + disc
    l2 = (a + b) / 2 - disc
    th = 0.5 * np.arctan2(2 * c, a - b)
    eps = 1e-20
    return (np.log(np.maximum(l1, eps)), np.log(np.maximum(l2, eps)), th)


def A_from_eig(lg1, lg2, th):
    l1, l2 = np.exp(lg1), np.exp(lg2)
    cs, sn = np.cos(th), np.sin(th)
    k = lg1.shape[0]
    R = np.zeros((k, 2, 2))
    R[:, 0, 0], R[:, 0, 1] = cs, -sn
    R[:, 1, 0], R[:, 1, 1] = sn, cs
    M = R @ (R * np.stack([l1, l2], 1)[:, None, :]).swapaxes(1, 2)
    M = (M + np.swapaxes(M, 1, 2)) / 2
    return np.linalg.cholesky(M).astype(np.float32)


def canonicalize(params):
    """Flip steering columns so that every diagonal entry is positive.
    A A^T is invariant to per-column sign flips; only the determinant
    normalizer prod(diag A) sees the change.  Returns a new params dict."""
    p = {k: np.array(v) for k, v in params.items()}
    Ad, Ac = p["A_diagonal"], p["A_corr"]
    d = Ad.shape[-1]
    for j in range(d):
        flip = Ad[:, j, j] < 0
        Ad[flip, j, j] *= -1
        Ac[flip, :, j] *= -1          # the column lives across both arrays
    return p


def uq(x, bits, axis=0):
    lb = np.amin(x, axis=axis, keepdims=True)
    ub = np.amax(x, axis=axis, keepdims=True)
    step = 2 ** bits - 1
    q = np.round((x - lb) / (ub - lb + RANGE_EPS) * step)
    return q.astype(np.int64), (q / step * (ub - lb) + lb)


def coded_bits(streams, width_of, mus_nbr, k):
    """Real coded size of per-kernel integer streams (one shared coder);
    the mode selection of bitstream._symbol_stream."""
    vals, nbits, group = [], [], []
    for name, v in streams.items():
        v = v.reshape(-1).astype(np.int64)
        b = width_of[name]
        cands = {"raw": (v.astype(np.uint32), b)}
        med = int(np.median(v))
        cands[f"const:{med}"] = (_zigzag(v - med), b + 1)
        if k > 1 and v.size % k == 0:
            cands["delta"] = (_delta_encode(v.astype(np.uint32), k), b + 1)
            if mus_nbr is not None:
                cands["nbr"] = (_nbr_encode(v.astype(np.uint32), k,
                                            mus_nbr), b + 1)
        mode = min(cands, key=lambda m: _est_bits(cands[m][0]))
        cv, cb = cands[mode]
        vals.append(cv)
        nbits.append(np.full(cv.size, cb, np.uint8))
        group.append(np.zeros(cv.size, np.uint8))
    data = encode_symbols(np.concatenate(vals), np.concatenate(nbits),
                          np.concatenate(group))
    return len(data) * 8


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", help="float-params .pkl or .smoe bitstream")
    ap.add_argument("--size", type=int, default=256)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    if args.model.endswith(".pkl"):
        params, cfg = load_fit(args.model)
        # reduce to live kernels once, as the codec does
        live = np.asarray(params["pis"]) > 0
        params = {k: (np.asarray(v)[live] if k in KERNEL_FIELDS
                      else np.asarray(v))
                  for k, v in params.items()}
    else:
        qp0, hdr = read_bitstream(args.model)
        from smoe_tpu_torch.config import SmoeConfig
        cfg = SmoeConfig(dim_domain=2, num_channels=3,
                         kernels_per_dim=tuple(hdr["kernels_per_dim"]),
                         precision=int(hdr.get("precision", 8)),
                         use_yuv=True, use_determinant=True,
                         bit_depths=tuple(hdr["bit_depths"]))
        rp0 = rescaler(qp0, cfg)
        params = {"pis": rp0["pis"], "musX": rp0["musX"],
                  "nu_e": rp0["nu_e"], "gamma_e": rp0["gamma_e"],
                  "A_diagonal": np.stack([np.diag(np.diag(a))
                                          for a in rp0["A"]]),
                  "A_corr": np.stack([np.tril(a, -1) for a in rp0["A"]])}
    assert cfg.dim_domain == 2 and not cfg.radial_as \
        and not cfg.train_inverse_cov
    k = int(params["pis"].shape[0])

    from smoe_tpu_torch.bench.flagship import build_image
    target = build_image(args.size)

    from smoe_tpu_torch.codec.serve import (_round_up, make_decoder,
                                            pad_decoded_params)
    cap = _round_up(k, 128)
    dec = make_decoder((args.size, args.size), 3, cfg, cap, device=device)

    def psnr_of(rp):
        pad = pad_decoded_params(dict(rp), cap, 2, 3)
        rec = dec(pad["A"], pad["musX"], pad["nu_e"], pad["gamma_e"],
                  pad["pis"]).cpu().numpy()
        return round(10 * np.log10(1.0 / float(np.mean((rec - target) ** 2))),
                     3)

    def rp_of(params):
        return {"A": (params["A_diagonal"]
                      + params["A_corr"]).astype(np.float32),
                "musX": params["musX"].astype(np.float32),
                "nu_e": params["nu_e"].astype(np.float32),
                "gamma_e": params["gamma_e"].astype(np.float32),
                "pis": params["pis"].astype(np.float32)}

    def quantized_eval(params, bit_depths, label):
        c = dataclasses.replace(cfg, bit_depths=tuple(bit_depths))
        qp = quantize_params(dict(params), c)
        rp = rescaler(qp, c)
        with tempfile.NamedTemporaryFile(suffix=".smoe") as tf:
            bits = write_bitstream(tf.name, qp, c)
        return {"variant": label, "psnr_db": psnr_of(rp),
                "coded_bits": int(bits),
                "proxy_bits": k * (bit_depths[0] * 3 + bit_depths[1] * 2
                                   + bit_depths[2] * 3 + bit_depths[3]
                                   + bit_depths[4] * 6)}

    out = []
    bd = list(cfg.bit_depths)

    # 1+2: float reference, raw vs canonicalized
    canon = canonicalize(params)
    neg = int(np.sum(np.diagonal(np.asarray(params["A_diagonal"]),
                                 axis1=1, axis2=2) < 0))
    out.append({"variant": "float (raw signs)", "psnr_db":
                psnr_of(rp_of(params)), "neg_diag_entries": neg})
    out.append({"variant": "float canonicalized",
                "psnr_db": psnr_of(rp_of(canon))})

    # 3: shipping quantization, raw vs canonical; per-group attribution
    out.append(quantized_eval(params, bd, "q-reference (raw signs)"))
    out.append(quantized_eval(canon, bd, "q-reference canonical"))
    cbase = dataclasses.replace(cfg, bit_depths=tuple(bd))
    qp_base = quantize_params(dict(canon), cbase)
    rp_base = rescaler(qp_base, cbase)
    fl = rp_of(canon)
    for g in ("A", "musX", "nu_e", "pis", "gamma_e"):
        rp = dict(rp_base)
        rp[g] = fl[g]
        out.append({"variant": f"q-ref but {g}@float",
                    "psnr_db": psnr_of(rp)})

    # 4: A-domain sweep on the canonicalized model
    mus_int = np.round(np.asarray(qp_base["musX"])).astype(np.int64)
    mus_nbr = _causal_nbr(mus_int.reshape(k, -1))
    for b in (16, 14, 12, 10, 8):
        out.append(quantized_eval(canon, [b] + bd[1:], f"lin-{b}"))
    A_low = np.tril(fl["A"].astype(np.float64))
    lg1, lg2, th = eig_of_A(A_low)
    for bl, bt in ((20, 20), (14, 12), (12, 10), (10, 8), (8, 8)):
        q1, d1 = uq(lg1, bl)
        q2, d2 = uq(lg2, bl)
        qt, dt = uq(th, bt)
        bits = coded_bits({"l1": q1, "l2": q2, "th": qt},
                          {"l1": bl, "l2": bl, "th": bt}, mus_nbr, k)
        rp = dict(rp_base)
        rp["A"] = A_from_eig(d1, d2, dt)
        out.append({"variant": f"eig-{bl}/{bt}", "psnr_db": psnr_of(rp),
                    "a_coded_bits": bits, "a_proxy_bits": k * (2 * bl + bt)})

    # 5: other-group allocation around the reference defaults
    for label, bdv in (("mu14", [bd[0], 14] + bd[2:]),
                       ("mu12", [bd[0], 12] + bd[2:]),
                       ("nu8", bd[:2] + [8] + bd[3:]),
                       ("nu10", bd[:2] + [10] + bd[3:]),
                       ("g8", bd[:4] + [8]),
                       ("g12", bd[:4] + [12]),
                       ("pi8", bd[:3] + [8, bd[4]]),
                       ("lean A12 mu14 nu8 g8", [12, 14, 8, 10, 8]),
                       ("lean A10 mu12 nu8 g8", [10, 12, 8, 10, 8]),
                       # -ulean is the last transparent step of every
                       # group; the three below-knee probes each break
                       ("ulean A8 mu10 nu8 g6", [8, 10, 8, 10, 6]),
                       ("below-knee A6", [6, 10, 8, 10, 6]),
                       ("below-knee mu8", [8, 8, 8, 10, 6]),
                       ("below-knee g4", [8, 10, 8, 10, 4])):
        out.append(quantized_eval(canon, bdv, label))

    for r in out:
        print(json.dumps(r), flush=True)
    summary = {"metric": "codec_rd_study", "kernels": k,
               "image": f"bench.build_image({args.size})",
               "ref_bit_depths": bd, **common.card_fields(device)}
    print(json.dumps(summary), flush=True)
    return out + [summary]


if __name__ == "__main__":
    main()
