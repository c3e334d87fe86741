"""Where does the fused gate+expert forward's time go on the card?

Counterpart of scripts/bench_contraction.py: times K1 (the production
forward) and the five ablation variants of K3
(kernels/gate_expert_variants.py) at the 512^2 x 256-kernel bench geometry,
each beside its plain torch version, and reports the elementwise share
(full - no_exp) / full.

    python -m smoe_tpu_torch.diag.contraction [--n 262144] [--k 256] \\
        [--reps 5] [--iters 50]

It prints one line per kernel, the share, and one JSON line.  It needs a
CUDA device and exits non-zero without one: a CPU run times nothing of
the card.

On this card every maha product is an fp32 FMA (no MXU, no tensor
cores), so `no_exp` is the floor of the FMA work, not a matmul floor, and
the share counts the exponentials, the denominator pass, the division and
the cull.  K1 - full is K1's survivor merge, xe tail and candidate
bookkeeping: the variants keep K1's plain two-pass loop over every kernel,
while K1 visits in its second pass only its CTA's candidate kernels (on
these inputs, where few pairs are culled, nearly every kernel is one).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

THR, FLOOR = 1e-4, 1e-11         # bench_contraction.py:76, :162


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


def run(n: int = 512 * 512, k: int = 256, reps: int = 5, iters: int = 50,
        log=print) -> dict:
    """Time K1 and every K3 mode, each beside its plain torch version, on
    the first CUDA device.  Returns {"n", "k", "device", "production":
    {"ms", "plain_ms"}, "variants": {mode: {"ms", "plain_ms",
    "max_abs_err", "max_abs_plain"}}, "elementwise_share",
    "k1_minus_full_ms"}."""
    import torch

    from smoe_tpu_torch.kernels.gate_expert import (gate_expert_fwd,
                                                    gate_expert_reference)
    from smoe_tpu_torch.kernels.gate_expert_variants import (
        VARIANTS, gate_expert_variant, gate_expert_variant_reference)

    if not torch.cuda.is_available():
        raise RuntimeError("diag.contraction times the card: no CUDA "
                           "device is available")
    phi, xe, q, G, pi_det, mask = (torch.as_tensor(a, device="cuda")
                                   for a in make_inputs(n, k))
    out = {"n": n, "k": k, "device": torch.cuda.get_device_name(0),
           "thr": THR, "floor": FLOOR, "iters": iters, "reps": reps}

    # production op (forward only), for scale reference (:159-165)
    t = time_launches(lambda: gate_expert_fwd(phi, xe, q, G, pi_det, mask,
                                              THR, FLOOR), iters, reps)
    tp = time_launches(lambda: gate_expert_reference(
        phi, xe, q, G, pi_det, mask, THR, FLOOR), iters, reps)
    out["production"] = {"ms": t * 1e3, "plain_ms": tp * 1e3}
    log(f"production fused fwd (K1)   : {t * 1e3:8.3f} ms   plain "
        f"{tp * 1e3:8.3f} ms")

    out["variants"] = {}
    for mode in VARIANTS:
        t = time_launches(lambda m=mode: gate_expert_variant(
            phi, q, G, pi_det, m, THR, FLOOR), iters, reps)
        tp = time_launches(lambda m=mode: gate_expert_variant_reference(
            phi, q, G, pi_det, m, THR, FLOOR), iters, reps)
        ref = gate_expert_variant_reference(phi, q, G, pi_det, mode, THR,
                                            FLOOR)
        err = float((gate_expert_variant(phi, q, G, pi_det, mode, THR, FLOOR)
                     - ref).abs().max())
        out["variants"][mode] = {"ms": t * 1e3, "plain_ms": tp * 1e3,
                                 "max_abs_err": err,
                                 "max_abs_plain": float(ref.abs().max())}
        log(f"variant {mode:12s}        : {t * 1e3:8.3f} ms   plain "
            f"{tp * 1e3:8.3f} ms   max |diff| {err:.2e}")

    full = out["variants"]["full"]["ms"]
    floor_t = out["variants"]["no_exp"]["ms"]
    out["elementwise_share"] = (full - floor_t) / full
    out["k1_minus_full_ms"] = out["production"]["ms"] - full
    log(f"\nN={n} K={k}: elementwise share = "
        f"{out['elementwise_share'] * 100:.1f}% of the forward "
        f"(full {full:.3f} ms vs no-exp FMA floor {floor_t:.3f} ms); "
        f"K1 - full = {out['k1_minus_full_ms']:.3f} ms (survivor merge, "
        f"xe tail and candidate bookkeeping)")
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
