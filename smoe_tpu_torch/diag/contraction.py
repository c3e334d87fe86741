"""Where does the fused gate+expert forward's time go on the card?

Counterpart of scripts/bench_contraction.py: times K1 (the production
forward) and the five ablation variants of K3
(kernels/gate_expert_variants.py), each beside the least time the card
could take for its work (`mode_bound`), and reports the elementwise share
(full - no_exp) / full and K1 - full.  By default on the JAX script's
inputs (the 512^2 x 256-kernel bench geometry, `make_inputs`), each mode
also beside its plain torch version's time; `run(operands=...)` takes K1's
operands as a main path gives them instead (a fit's block, a decode's
raster).

    python -m smoe_tpu_torch.diag.contraction [--n 262144] [--k 256] \\
        [--reps 5] [--iters 50]

It prints one line per kernel, the shares, and one JSON line.  It needs a
CUDA device and exits non-zero without one: a CPU run times nothing of
the card.

K1 and every K3 mode are instances of one forward body
(kernels/csrc/gate_expert_fwd_body.cuh).  `full` and `exp2` keep K1's
per-CTA candidates (pass 2 visits only the kernels that may survive
somewhere in the CTA) and skip the division of a certainly culled pair;
they drop the survivor merge and the xe mix (and K1's optional denominator
and stats outputs, which the tool does not ask K1 for), so K1 - full is
what the survivor merge and the xe mix cost K1.  `no_cull` cannot cull, so it
has no candidates: it divides and mixes every pair.  `no_norm` and
`no_exp` take one pass over every pair.  On this card every maha product
is an fp32 FMA (no MXU, no tensor cores), so `no_exp` is the floor of the
dense FMA work, not a matmul floor, and the elementwise share counts the
exponentials, the denominator pass, the division and the cull.  It can be
negative: on raster operands, where a CTA's pixels are neighbours and few
kernels are candidates, `no_exp` mixes every pair while `full` visits
only the candidates.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

THR, FLOOR = 1e-4, 1e-11         # bench_contraction.py:76, :162
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): fp32
# outside the tensor cores, and HBM3 bandwidth
FP32_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
# the SFU (MUFU: ex2, rcp) at 16 results a clock per SM (CUDA C++
# Programming Guide, arithmetic instructions, compute capability 9.0)
# against 128 fp32 lanes of 2 flops: at the clock that gives the fp32 peak
MUFU_PEAK_OPS = FP32_PEAK_FLOPS * 16 / 256
C_DIM = 3                         # K3's fixed channel count
# K3 against its plain version: absolute for the modes whose weights are
# normalised (res is O(1)); relative to max |plain| for no_norm (weights
# pi*det, up to ~1e2 on model-shaped inputs) and no_exp (weights -maha/2,
# up to ~1e4).  A row of full or exp2 whose plain weights hold a pair
# within 1e-5 relative of the cull threshold may flip it: such rows are
# counted apart, never absorbed.
VAR_ABS_TOL, VAR_REL_TOL = 1e-5, 1e-5
CULLED = ("full", "exp2")


def var_tol(mode: str, max_abs_plain: float) -> float:
    if mode in ("no_norm", "no_exp"):
        return VAR_REL_TOL * max_abs_plain
    return VAR_ABS_TOL


def mode_work(mode: str, n: int, k: int, f: int, e: int, c: int,
              survivors: int):
    """(fp32 flops, MUFU ops, bytes) of the least work of one forward over
    P = N * K pairs with S surviving pairs: "production" is K1, the others
    K3's modes (C = 3, no xe).

        mode               flops                        MUFU
        production, full,  (2F + 4) P + (1 + 2EC) S     P + S
          exp2
        no_cull            (2F + 4) P + (1 + 2EC) P     2P
        no_norm            (2F + 2) P + 2EC P           P
        no_exp             (2F + 1) P + 2EC P           0

    A pair's gate: F maha FMAs (2F), the clamp, exp (one MUFU op) and the
    pi_det multiply, the denominator add; a weight that is mixed: the
    division (one MUFU op, counted a flop) and E*C mixing FMAs.  Bytes:
    each input read once, each output written once (phi, res, q', G,
    pi_det; K1 also xe and surv)."""
    p, ec = n * k, e * c
    s = survivors
    if mode in ("production", "full", "exp2"):
        flops, mufu = (2 * f + 4) * p + (1 + 2 * ec) * s, p + s
    elif mode == "no_cull":
        flops, mufu = (2 * f + 4) * p + (1 + 2 * ec) * p, 2 * p
    elif mode == "no_norm":
        flops, mufu = (2 * f + 2) * p + 2 * ec * p, p
    elif mode == "no_exp":
        flops, mufu = (2 * f + 1) * p + 2 * ec * p, 0
    else:
        raise ValueError(f"mode_work: unknown mode {mode!r}")
    per_pixel = f + c + (e if mode == "production" else 0)
    per_kernel = f + ec + {"production": 2, "no_exp": 0}.get(mode, 1)
    return flops, mufu, 4 * (n * per_pixel + k * per_kernel)


def bound(flops: float, nbytes: float):
    """(least ms, what binds): the larger of the operations over the fp32
    peak and the bytes over the memory bandwidth."""
    t_op, t_b = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_op, t_b) * 1e3, "operations" if t_op >= t_b else "bytes"


def mode_bound(mode: str, n: int, k: int, f: int, e: int, c: int,
               survivors: int) -> dict:
    """`mode_work` as times on the card: bound_ms and bound_by (fp32 flops
    against bytes, `bound`), and mufu_ms, the MUFU ops over the SFU's peak,
    reported beside the bound."""
    flops, mufu, nbytes = mode_work(mode, n, k, f, e, c, survivors)
    ms, by = bound(flops, nbytes)
    return {"bound_ms": ms, "bound_by": by,
            "mufu_ms": mufu / MUFU_PEAK_OPS * 1e3, "flops": flops,
            "mufu_ops": mufu, "bytes": nbytes}


def make_inputs(n: int, k: int):
    """The script's inputs (bench_contraction.py:139-153), drawn from the
    same numpy generator in the same order: phi (N, 7), xe (N, 3),
    q (K, 7), G (K, 9), pi_det (K,), mask (K,), all float32."""
    rng = np.random.default_rng(0)
    d, c = 2, 3
    side = int(np.sqrt(n))
    y, x = np.mgrid[0:side, 0:side] / (side - 1)
    coords = np.stack([y, x], -1).reshape(-1, d).astype(np.float32)
    phi = np.concatenate([
        (coords[:, :, None] * coords[:, None, :]).reshape(-1, d * d),
        coords, np.ones((coords.shape[0], 1), np.float32)], 1)[:n]
    xe = np.concatenate([coords, np.ones((coords.shape[0], 1),
                                         np.float32)], 1)[:n]
    q = rng.normal(0, 3, (k, d * d + d + 1)).astype(np.float32)
    G = rng.normal(0, .1, (k, (d + 1) * c)).astype(np.float32)
    pi_det = np.full((k,), 1.0 / k, np.float32)
    mask = np.ones((k,), np.float32)
    return phi, xe, q, G, pi_det, mask


def time_launches(fn, iters: int = 50, reps: int = 5) -> float:
    """Seconds per call of fn on the card: CUDA events around `iters`
    back-to-back calls, median over `reps` (the counterpart of time_fn,
    bench_contraction.py:114-128).  Eager torch neither drops an unused
    result nor hoists a repeated call, so the calls need no carry between
    them."""
    import torch
    fn()                                       # build, load, warm
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        ts.append(t0.elapsed_time(t1) / 1e3 / iters)
    return float(np.median(ts))


def versus_plain(phi, q, G, pi_det, mode: str, got, thr: float,
                 floor: float, rows: int, stride: int = 1) -> dict:
    """K3's result `got` (N, 3) against the plain version, `rows` rows per
    plain call, on every `stride`-th row: max |diff|, max |plain|, the
    tolerance (`var_tol`), rows over it and, for full and exp2, the rows
    over it that hold a pair within 1e-5 relative of the cull threshold
    (cull flips, counted apart)."""
    import torch
    from smoe_tpu_torch.kernels.gate_expert_variants import (
        gate_expert_variant_reference, variant_weights)
    n = phi.shape[0]
    d_rows, near_rows, scale = [], [], 0.0
    for i in range(0, n, rows * stride):
        sl = slice(i, min(n, i + rows * stride), stride)
        ref = gate_expert_variant_reference(phi[sl], q, G, pi_det, mode,
                                            thr, floor)
        d = (got[sl] - ref).abs().amax(1)
        scale = max(scale, float(ref.abs().max()))
        near = torch.zeros_like(d, dtype=torch.bool)
        if mode in CULLED and bool((d > VAR_ABS_TOL).any()):
            w = variant_weights(phi[sl], q, pi_det, mode, thr, floor,
                                cull=False)
            near = ((w - thr).abs() <= 1e-5 * thr).any(1)
            del w
        d_rows.append(d)
        near_rows.append(near)
        del ref
    d, near = torch.cat(d_rows), torch.cat(near_rows)
    tol = var_tol(mode, scale)
    bad = d > tol
    return {"rows_checked": int(d.numel()), "max_abs_err": float(d.max()),
            "max_rel_err": float(d.max()) / max(scale, 1e-30),
            "max_abs_plain": scale, "tol": tol,
            "cull_flip_rows": int((bad & near).sum()),
            "rows_over_tol": int((bad & ~near).sum())}


def run(n: int = 512 * 512, k: int = 256, reps: int = 5, iters: int = 50,
        log=print, operands=None, thr: float = THR, floor: float = FLOOR,
        plain_ms: bool = True, stride: int = 1) -> dict:
    """Time K1 and every K3 mode on the first CUDA device, each beside its
    bound (`mode_bound`), K1 and `full` in turns (K1, full, full, K1);
    hold every mode against its plain version (`versus_plain` on every
    `stride`-th row, in chunks of about 1 GB per (rows, K) map) and `full`
    bit for bit against K1 with xe = 1, mask = 1.

    operands: K1's (phi, xe, q, G, pi_det, mask) on the card, G (K, E*3);
    K3, which has no mask, takes q * mask (exact: a 0/1 or power-of-two
    scale commutes with the -0.5 prescale).  None: the JAX script's inputs
    at (n, k).  plain_ms: also time each plain version (on the script's
    inputs; it is no yardstick).  Returns {"n", "k", "f", "e", "device",
    "pairs", "survivors", "candidate_fraction", "production": {"ms",
    "readings_ms", bound...}, "variants": {mode: {"ms", bound...,
    "share_of_bound", versus_plain's keys}}, "elementwise_share",
    "k1_minus_full_ms"}."""
    import torch

    from smoe_tpu_torch.kernels.gate_expert import (gate_expert_fwd,
                                                    gate_expert_reference)
    from smoe_tpu_torch.kernels.gate_expert_variants import (
        VARIANTS, gate_expert_variant, gate_expert_variant_reference)

    if not torch.cuda.is_available():
        raise RuntimeError("diag.contraction times the card: no CUDA "
                           "device is available")
    if operands is None:
        operands = tuple(torch.as_tensor(a, device="cuda")
                         for a in make_inputs(n, k))
    phi, xe, q, G, pi_det, mask = operands
    n, f = phi.shape
    k, e = q.shape[0], xe.shape[1]
    if G.shape[1] != e * C_DIM:
        raise ValueError(f"diag.contraction: K3 takes C = {C_DIM} channels; "
                         f"G is {tuple(G.shape)} with E = {e}")
    q3 = (q * mask[:, None]).contiguous()
    rows = min(32768, max(256, (1 << 28) // max(k, 1)))
    k3_args = (phi, q3, G, pi_det)
    stats = torch.zeros((2,), dtype=torch.int64, device=phi.device)
    gate_expert_fwd(*operands, thr, floor, stats=stats)
    visited, survivors = (int(v) for v in stats.tolist())
    out = {"n": n, "k": k, "f": f, "e": e,
           "device": torch.cuda.get_device_name(0), "thr": thr,
           "floor": floor, "iters": iters, "reps": reps, "pairs": n * k,
           "survivors": survivors, "candidate_fraction": visited / (n * k)}

    def k1():
        return gate_expert_fwd(*operands, thr, floor)

    def k3(mode):
        return gate_expert_variant(*k3_args, mode, thr, floor)

    def timed(fn):
        return time_launches(fn, iters, reps) * 1e3

    k1_r, full_r = timed(k1), timed(lambda: k3("full"))
    full_r2, k1_r2 = timed(lambda: k3("full")), timed(k1)
    p = out["production"] = {"ms": (k1_r + k1_r2) / 2,
                             "readings_ms": [k1_r, k1_r2],
                             **mode_bound("production", n, k, f, e, C_DIM,
                                          survivors)}
    p["share_of_bound"] = p["bound_ms"] / p["ms"]
    if plain_ms:
        p["plain_ms"] = timed(
            lambda: gate_expert_reference(*operands, thr, floor))
    log(f"production fused fwd (K1)   : {p['ms']:8.4f} ms   bound "
        f"{p['bound_ms']:8.4f} ms")

    k1_ones, _ = gate_expert_fwd(phi, torch.ones_like(xe), q3, G, pi_det,
                                 torch.ones_like(mask), thr, floor)
    out["variants"] = {}
    for mode in VARIANTS:
        got = k3(mode)
        torch.cuda.synchronize()
        m = versus_plain(*k3_args, mode, got, thr, floor, rows, stride)
        if mode == "full":
            m["bit_identical_to_k1"] = bool(torch.equal(got, k1_ones))
            m["ms"], m["readings_ms"] = (full_r + full_r2) / 2, [full_r,
                                                                 full_r2]
        else:
            m["ms"] = timed(lambda md=mode: k3(md))
        del got
        m.update(mode_bound(mode, n, k, f, e, C_DIM, survivors))
        m["share_of_bound"] = m["bound_ms"] / m["ms"]
        if plain_ms:
            m["plain_ms"] = timed(
                lambda md=mode: gate_expert_variant_reference(
                    *k3_args, md, thr, floor))
        out["variants"][mode] = m
        log(f"variant {mode:12s}        : {m['ms']:8.4f} ms   bound "
            f"{m['bound_ms']:8.4f} ms ({m['bound_by']}; MUFU "
            f"{m['mufu_ms']:.4f} ms)   max |diff| {m['max_abs_err']:.2e}")
    del k1_ones

    full = out["variants"]["full"]["ms"]
    floor_t = out["variants"]["no_exp"]["ms"]
    out["elementwise_share"] = (full - floor_t) / full
    out["k1_minus_full_ms"] = p["ms"] - full
    log(f"\nN={n} K={k} F={f}: elementwise share = "
        f"{out['elementwise_share'] * 100:.1f}% of the forward "
        f"(full {full:.4f} ms vs no-exp {floor_t:.4f} ms); K1 - full = "
        f"{out['k1_minus_full_ms']:.4f} ms (survivor merge and xe mix); "
        f"candidate fraction {out['candidate_fraction']:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=512 * 512)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("diag.contraction: torch.cuda.is_available() is False; the "
              "attribution times the card and does not run on the CPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(a.n, a.k, a.reps, a.iters)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
