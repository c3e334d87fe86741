"""What the per-layer readers share: the kernels' names in the device
trace and the least time of the launches a traced slice made, from the
work the driver counted with the reference (`yardstick.work`)."""

from __future__ import annotations

from yardstick import trace as tr
from yardstick import work as W

# device kernels of K1 and of K2 (K2 is three kernels a launch)
K1_NAMES = ("gate_expert_fwd_kernel",)
K2_NAMES = ("bwd_pixel_kernel", "bwd_accum_kernel", "bwd_reduce_kernel")
K2_FIRST = ("bwd_pixel_kernel",)


def device_s(m: dict, names) -> float:
    return sum(e - s for _, s, e in tr.matching(m["slice"], names))


def fit_launch_work(m: dict, kernel: str):
    """(least seconds, flops) of the slice's K1 or K2 launches: each sweep
    launches one a block at the sweep's listed width; K1's launches beyond
    those are the evals', one a block at the eval's listed width."""
    w = m["fit_work"]
    f, e, c = w["f"], w["e"], w["c"]
    fn = W.k1_work if kernel == "k1" else W.k2_work
    names = K1_NAMES if kernel == "k1" else K2_FIRST
    launches = len(tr.matching(m["slice"], names))
    blocks = w["blocks"]
    sweeps = m["slice_sweeps"]
    per = [fn(n, k_s, f, e, c, s) for n, k_s, _, s in blocks]
    per_eval = [fn(n, k_e, f, e, c, s) for n, _, k_e, s in blocks]
    evals = max(launches - sweeps * len(blocks), 0) / len(blocks) \
        if kernel == "k1" else 0.0
    t = sum(sweeps * W.bound_s(fl, by) for fl, by in per) \
        + sum(evals * W.bound_s(fl, by) for fl, by in per_eval)
    flops = sum(sweeps * fl for fl, _ in per) \
        + sum(evals * fl for fl, _ in per_eval)
    return t, flops


def decode_launch_work(m: dict):
    """(least seconds, flops) of the slice's K1 launches, one a request
    over every pixel and every coded kernel of its file."""
    w = m["decode_work"]
    f, e, c = W.widths(2, 3)
    t = flops = 0.0
    for fi in m["request_files"]:
        k, s = w["files"][fi]
        fl, by = W.k1_work(w["pixels"], k, f, e, c, s)
        t += W.bound_s(fl, by)
        flops += fl
    return t, flops
