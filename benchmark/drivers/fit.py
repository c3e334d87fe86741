"""Driver of the fit cells: `Smoe.train`, the loop `cli.fit` runs.

Set-up: the configuration's image from the seed, the grid initialisation
the benchmark computes itself (`reference.smoe_ref.grid_init`, handed to
`Smoe(init_params_dict=...)` as the CLI's own init would make it), the
mix's least-squares initialisation, the first checked stage, then the
warm-up calls until the capped width stops changing.  Window: `train` calls
of the mix's size until `--seconds` have passed, timed at call boundaries.
With --trace 1 one more call runs under the profiler.  Then the second
checked stage, from the state the window ended in, at its width.

A checked stage is `train(1)` and `train(2)` with the window's own
arguments (the first gradient is read from Adam's state before and after
one step), then the mix's refresh: the kernel LS refresh where the mix
refreshes the experts, `update_kernel_list` where the lists are refreshed
outside the graph.  Once the program is freed, the reference follows each
stage from the state the program started it from: the first from the
grid init (the reference's own lists, LS initialisation and a fresh Adam),
the second from the program's params, lists and Adam state.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from reference import smoe_ref as R  # noqa: E402
from yardstick import card, content, trace as tr  # noqa: E402

FIELDS = R.FIELDS
BETA1 = 0.9
# warm-up calls at most, waiting for the capped width to settle
MAX_WARM_CALLS = 6


def _host(params) -> dict:
    return {f: getattr(params, f).detach().cpu().clone() for f in FIELDS}


def _lists(s) -> torch.Tensor:
    return s.kernel_lists.detach().cpu().clone()


def _bucket(s) -> int:
    """The 128 bucket of the largest list count, read from the public
    lists (the capped width follows it)."""
    n = int(s.kernel_lists.sum(dim=1).max())
    return -(-n // 128)


def _adam(s):
    """Adam's state on the host: (first moments, second moments) by field
    and the step count; zeros and 0 where no step has run."""
    state = s.optimizer.state
    m, v, t = {}, {}, 0
    for f in FIELDS:
        p = getattr(s.params, f)
        st = state.get(p, {})
        if "exp_avg" in st:
            m[f] = st["exp_avg"].detach().cpu().clone()
            v[f] = st["exp_avg_sq"].detach().cpu().clone()
            t = int(st["step"])
        else:
            m[f] = torch.zeros(p.shape)
            v[f] = torch.zeros(p.shape)
    return m, v, t


def ref_cfg(cfg: dict) -> dict:
    return {"precision": int(cfg["precision"]), "use_yuv": cfg["use_yuv"],
            "use_determinant": cfg["use_determinant"],
            "probe_maha": cfg["probe_maha_threshold"]}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: dict, ref: dict, keep, scale: dict = None) -> float:
    """Worst leaf: |‖prog‖ − ‖ref‖| over the larger of the leaf's and the
    median leaf's norm of `scale` (default `ref`), over the leaves in
    `keep`."""
    scale = ref if scale is None else scale
    sn = {f: _norm(scale[f]) for f in keep}
    if not sn:
        return 0.0
    med = float(np.median(list(sn.values())))
    gaps = [abs(_norm(prog[f]) - _norm(ref[f])) / max(sn[f], med, 1e-30)
            for f in keep]
    return max(gaps)


def checked_stage(s, call: dict, mix: dict) -> dict:
    """`train(1)` and `train(2)` from the trainer's state as it stands,
    then the mix's refresh: the record the reference follows."""
    rec = {"p0": _host(s.params), "lists0": _lists(s), "adam0": _adam(s)}
    losses = []
    chunk = s.run_batched_chunk

    def recording_chunk(*a, **k):
        out = chunk(*a, **k)
        losses.extend(float(v) for v in out[0])
        return out

    s.run_batched_chunk = recording_chunk
    s.train(**dict(call, num_iter=1))
    # Adam's first moment after one step is beta1 m0 + (1 - beta1) g
    m0, m1 = rec["adam0"][0], _adam(s)[0]
    rec["g1"] = {f: (m1[f] - BETA1 * m0[f]) / (1 - BETA1) for f in FIELDS}
    s.train(**dict(call, num_iter=2))
    s.run_batched_chunk = chunk
    rec["losses"] = losses[:3]
    rec["p3"] = _host(s.params)
    rec["lists3"] = _lists(s)
    if mix.get("ls_refresh_iter"):
        s.ls_init_experts("kernel")
        rec["p3_ls"] = _host(s.params)
    if not mix.get("in_graph_ukl"):
        s.update_kernel_list()
        rec["lists_ukl"] = _lists(s)
    return rec


def run(ctx: dict) -> dict:
    cfg, mix, dev = ctx["cfg"], ctx["traffic"], torch.device(ctx["device"])
    faults = ctx["faults"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from smoe_tpu_torch.fit.trainer import Smoe

    marks = [("start", ctx["t_start"]), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    image = content.build(cfg["content"], ctx["seed"])
    kpd = int(cfg["kernels_per_dim"])
    init = R.grid_init(image, kpd)
    block = tuple(cfg["block_shape"]) if cfg.get("block_shape") \
        else image.shape[:2]
    in_graph = bool(mix["in_graph_ukl"])
    s = Smoe(image, kernels_per_dim=[kpd], init_params_dict=init,
             batch_size=block, use_yuv=bool(cfg["use_yuv"]),
             use_determinant=bool(cfg["use_determinant"]),
             probe_maha_threshold=float(cfg["probe_maha_threshold"]),
             precision=int(cfg["precision"]), in_graph_ukl=in_graph,
             device=dev)
    s.set_optimizer(**cfg["optimizer"])
    marks.append(("image and trainer", card.clock(dev)))
    _plant(s, faults)
    call = dict(num_iter=int(mix["sweeps_per_call"]),
                val_iter=int(mix["val_iter"]),
                ls_refresh_iter=mix.get("ls_refresh_iter"))
    rec = {"p_init": _host(s.params), "lists_init": _lists(s)}
    if mix.get("ls_init"):
        s.ls_init_experts(mix["ls_init"])
    marks.append(("LS init", card.clock(dev)))
    rec["start"] = checked_stage(s, call, mix)
    marks.append(("checked steps", card.clock(dev)))

    # warm-up: every width the window's calls will use is captured; the
    # in-graph refresh moves the width with each sweep, so one call
    prev = None
    for _ in range(1 if in_graph else MAX_WARM_CALLS):
        s.train(**call)
        b = _bucket(s)
        if b == prev:
            break
        prev = b

    # the window
    t0 = card.clock(dev)
    marks.append(("warm calls", t0))
    setup_s = t0 - ctx["t_start"]
    print("setup: " + ", ".join(f"{n} {b - a:.2f} s" for (_, a), (n, b)
                                in zip(marks, marks[1:])), file=sys.stderr)
    chunk_s0 = s.phase_timer.totals.get("train_sweeps", 0.0)
    sweeps, ends = 0, [t0]
    while True:
        s.train(**call)
        sweeps += call["num_iter"]
        ends.append(card.clock(dev))
        if ends[-1] - t0 >= ctx["seconds"]:
            break
    window_s = ends[-1] - t0
    chunk_s = s.phase_timer.totals.get("train_sweeps", 0.0) - chunk_s0
    per_call = np.diff(ends) / call["num_iter"] * 1e3
    print("look: window calls %d, ms/sweep by call min %.4f q1 %.4f median "
          "%.4f q3 %.4f max %.4f" % ((len(per_call), per_call.min())
                                     + tuple(np.percentile(per_call,
                                                           [25, 50, 75]))
                                     + (per_call.max(),)), file=sys.stderr)

    m = {"end_to_end": {"fit_ms_per_sweep": window_s / sweeps * 1e3,
                        "setup_s": setup_s},
         "window_s": window_s, "chunk_s": chunk_s, "sweeps": sweeps,
         "attempted": sweeps, "failed": 0}
    if ctx["trace"]:
        p_a, l_a = _host(s.params), _lists(s)
        sl = tr.profiled(lambda: s.train(**call), dev)
        m.update(slice=sl, slice_sweeps=call["num_iter"],
                 breakdown={"device_ops": tr.top_ops(sl),
                            "idle_gaps": tr.idle_gaps(sl)})
        rec["work"] = (p_a, l_a, _host(s.params), _lists(s))
    rec["end"] = checked_stage(s, call, mix)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    m["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card.card_fields(dev)["card"],
                   "count": 1, "memory_peak_bytes": int(peak)}
    if ctx["trace"]:
        m["device"]["busy_s"] = tr.busy_s(m["slice"])
        m["device"]["window_s"] = m["slice"].window_s
    m["power_limit_w"] = card.card_fields(dev)["power_limit_w"]
    blocks_shape = (tuple(s.bset.coords.shape[:2]))
    del s
    _unplant()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    m["checks"] = check(ctx, image, block, init, rec, "fp32")
    if ctx["trace"]:
        m["fit_work"] = work(ctx, image, block, rec["work"], blocks_shape)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return m


def _plant(s, faults: dict) -> None:
    """Faults planted under the timed path, for the tests and the control
    runs: "frozen" (a step that returns its state unchanged), "half" (half
    of the batch left out, the mean taken over the rest)."""
    if faults.get("frozen"):
        s._step = lambda *a, **k: None
    if faults.get("half"):
        import smoe_tpu_torch.fit.trainer as T
        orig = T._block_loss

        def half(params, cfg, coords, targets, *a, **k):
            n = coords.shape[0] // 2
            return orig(params, cfg, coords[:n], targets[:n], *a[:1],
                        None if a[1] is None else a[1][:n],
                        None if a[2] is None else a[2][:n], *a[3:], **k)
        _RESTORE.append(lambda: setattr(T, "_block_loss", orig))
        T._block_loss = half


_RESTORE = []


def _unplant() -> None:
    while _RESTORE:
        _RESTORE.pop()()


def check(ctx, image, block, init, rec, precision: str) -> dict:
    """The numbers that decide `correct`, each the worst of the two
    checked stages, each stage of the reference started from the state the
    program started it from."""
    cfg, mix = ctx["cfg"], ctx["traffic"]
    dev = torch.device(ctx["device"])
    ref = R.Ref(ref_cfg(cfg), precision)
    blocks = R.Blocks(image, block, dev)
    in_graph = bool(mix["in_graph_ukl"])

    # the grid initialisation's lists, then the LS initialisation
    p_init = R.params_from_init(init, dev)
    lists_init = ref.initial_lists(p_init, blocks)
    gaps = {"lists_diff": [int((lists_init.cpu() != rec["lists_init"]).sum())],
            "ls_gap": []}
    if mix.get("ls_init"):
        solve = R.ls_coupled if mix["ls_init"] in ("auto", "coupled") \
            else R.ls_kernel
        nu, ga = solve(ref, p_init, blocks, lists_init)
        p0 = rec["start"]["p0"]
        gaps["ls_gap"].append(leaf_gap(
            {"nu_e": p0["nu_e"] - rec["p_init"]["nu_e"],
             "gamma_e": p0["gamma_e"] - rec["p_init"]["gamma_e"]},
            {"nu_e": (nu - p_init["nu_e"]).cpu(),
             "gamma_e": (ga - p_init["gamma_e"]).cpu()},
            ("nu_e", "gamma_e")))

    # the first stage on the reference's own lists and a fresh Adam, the
    # second on the program's lists and Adam state as the window left them
    for name, lists in (("start", lists_init), ("end", None)):
        st = rec[name]
        if lists is None:
            lists = st["lists0"].to(dev)
        for k, v in stage_gaps(ref, blocks, st, lists, cfg, mix,
                               name).items():
            gaps.setdefault(k, []).append(v)

    out = {k: max(v) for k, v in gaps.items()
           if v and k in ("loss_gap", "grad_gap", "step_gap")}
    if gaps["ls_gap"]:
        out["ls_gap"] = max(gaps["ls_gap"])
    # under the in-graph refresh the lists are the probe-near set, which
    # both sides rebuild every sweep: nothing to compare
    if not in_graph:
        out["lists_diff"] = float(sum(gaps["lists_diff"]))
    return out


def stage_gaps(ref, blocks, st, lists, cfg, mix, name) -> dict:
    """One checked stage: the reference's three sweeps from the program's
    params `st["p0"]` on `lists` and Adam's state `st["adam0"]`, then the
    mix's refresh, against what the program recorded."""
    dev = blocks.coords.device
    put = lambda d: {f: v.to(dev) for f, v in d.items()}  # noqa: E731
    in_graph = bool(mix["in_graph_ukl"])
    m0, v0, t0 = st["adam0"]
    opt = R.Adam(**cfg["optimizer"], m=put(m0), v=put(v0), t=t0)
    p0 = put(st["p0"])
    losses, g1, p, lists = three_sweeps(ref, blocks, p0, lists, in_graph, opt)
    out = {"lists_diff": int((lists.cpu() != st["lists3"]).sum())}
    gn = {f: float(torch.linalg.vector_norm(g1[f].double())) for f in FIELDS}
    med = float(np.median(list(gn.values())))
    keep = [f for f in FIELDS if gn[f] >= 1e-3 * med]
    by_step = [abs(a - b) / abs(b) for a, b in zip(st["losses"], losses)]
    out["loss_gap"] = max(by_step)
    print(f"look: {name}: loss gap by step "
          + " ".join(f"{v:.3e}" for v in by_step)
          + "; first-step sign flips by leaf " + " ".join(
              f"{f}={int(((st['g1'][f] > 0) != (g1[f] > 0)).sum())}"
              for f in FIELDS) + "; leaves left out of the change "
          + (",".join(f for f in FIELDS if f not in keep) or "none"),
          file=sys.stderr)
    # every leaf's gradient: the median leaf's norm bounds a near-zero one
    out["grad_gap"] = leaf_gap(st["g1"], g1, FIELDS)
    out["step_gap"] = leaf_gap(
        {f: st["p3"][f] - st["p0"][f] for f in FIELDS},
        {f: (p[f] - p0[f]).cpu() for f in FIELDS}, keep)

    if mix.get("ls_refresh_iter"):
        # the refresh's change against the full least-squares step (t = 1):
        # the line search's t = -<r, u> / <u, u> cancels where it is small,
        # so a gap over the change itself would read the cancellation
        q = put(st["p3"])
        nu, ga, t, (dn, dg) = R.ls_kernel(ref, q, blocks,
                                          st["lists3"].to(dev), with_step=True)
        ls = ("nu_e", "gamma_e")
        moved = {f: st["p3_ls"][f] - st["p3"][f] for f in ls}
        want = {"nu_e": (nu - q["nu_e"]).cpu(),
                "gamma_e": (ga - q["gamma_e"]).cpu()}
        out["ls_gap"] = leaf_gap(moved, want, ls,
                                 {"nu_e": dn.cpu(), "gamma_e": dg.cpu()})
        print(f"look: {name}: LS refresh t {t:.4e}, gap over its own "
              f"change {leaf_gap(moved, want, ls):.3e}", file=sys.stderr)
    if not in_graph:
        q = put(st["p3"])
        new = st["lists3"].to(dev) | ref.near(q, blocks)
        out["lists_diff"] += int((new.cpu() != st["lists_ukl"]).sum())
    print(f"look: {name}: " + " ".join(f"{k} {v:.3e}" for k, v in
                                      out.items()), file=sys.stderr)
    return out


def three_sweeps(ref, blocks, p, lists, in_graph: bool, opt):
    """The reference's train(1) then train(2) from p on the lists the
    trainer holds, stepping `opt`: each call opens with an eval whose
    survivors become the lists (under the in-graph refresh the chunk then
    rebuilds them as the probe-near set), each sweep's survivors (|
    probe-near under the refresh) are the next sweep's lists, and each call
    closes with an eval.  Returns (the sweeps' losses, the first gradient,
    the params and the lists after the closing eval)."""
    def live(p):
        return (p["pis"] > 0)[None, :].expand(blocks.count, -1).clone()

    def eval_lists(p, lists):
        return ref.survivors(p, blocks, live(p) if in_graph else lists)

    losses, g1 = [], None
    for step in range(3):
        if step in (0, 1):
            if step == 1:
                lists = eval_lists(p, lists)
            lists = eval_lists(p, lists)
            if in_graph:
                lists = ref.near(p, blocks)
        g, loss, _, surv = ref.grads(p, blocks, lists)
        losses.append(loss)
        if g1 is None:
            g1 = {f: v.cpu() for f, v in g.items()}
        p = opt.step(p, g)
        lists = surv | ref.near(p, blocks) if in_graph else surv
    return losses, g1, p, eval_lists(p, lists)


def reference_record(ctx, image, block, init, precision: str) -> dict:
    """What the driver records of the program, made by the reference at
    `precision` put in the program's place (the control).  Its window is
    empty: the second stage starts where the first one's refresh left the
    params, the lists and Adam."""
    cfg, mix = ctx["cfg"], ctx["traffic"]
    dev = torch.device(ctx["device"])
    ref = R.Ref(ref_cfg(cfg), precision)
    blocks = R.Blocks(image, block, dev)
    in_graph = bool(mix["in_graph_ukl"])
    host = lambda d: {f: v.detach().cpu() for f, v in d.items()}  # noqa
    p = R.params_from_init(init, dev)
    lists = ref.initial_lists(p, blocks)
    rec = {"p_init": host(p), "lists_init": lists.cpu()}
    if mix.get("ls_init"):
        solve = R.ls_coupled if mix["ls_init"] in ("auto", "coupled") \
            else R.ls_kernel
        nu, ga = solve(ref, p, blocks, lists)
        p = dict(p, nu_e=nu, gamma_e=ga)
    opt = R.Adam(**cfg["optimizer"])
    for name in ("start", "end"):
        m0 = {f: opt.m.get(f, torch.zeros_like(p[f])).cpu() for f in FIELDS}
        st = {"p0": host(p), "lists0": lists.cpu(),
              "adam0": (m0, {f: opt.v.get(f, torch.zeros_like(p[f])).cpu()
                             for f in FIELDS}, opt.t)}
        losses, g, p, lists = three_sweeps(ref, blocks, p, lists, in_graph,
                                           opt)
        st.update(losses=losses, g1=g, p3=host(p), lists3=lists.cpu())
        if mix.get("ls_refresh_iter"):
            nu, ga = R.ls_kernel(ref, p, blocks, lists)
            p = dict(p, nu_e=nu, gamma_e=ga)
            st["p3_ls"] = host(p)
        if not in_graph:
            lists = lists | ref.near(p, blocks)
            st["lists_ukl"] = lists.cpu()
        rec[name] = st
    return rec


def work(ctx, image, block, snap, blocks_shape) -> dict:
    """What the traced call's kernels had to do, counted by the reference
    from its params at the call's start and end: per block the pixels N,
    the live kernels of its list (what a sweep's K1 and K2 gate over) and
    of the eval's list, and the pairs S that pass the cull, each the mean
    of the two ends."""
    cfg, mix = ctx["cfg"], ctx["traffic"]
    dev = torch.device(ctx["device"])
    ref = R.Ref(ref_cfg(cfg))
    blocks = R.Blocks(image, block, dev)
    p_a, l_a, p_b, l_b = snap
    n_blocks, n_pix = blocks_shape
    in_graph = bool(mix["in_graph_ukl"])
    per_end = []
    for p, lists in ((p_a, l_a), (p_b, l_b)):
        p = {f: v.to(dev) for f, v in p.items()}
        live = (p["pis"] > 0)[None, :].expand(n_blocks, -1)
        # a sweep gates over the probe-near set under the in-graph refresh,
        # else over the survivors the call's opening eval leaves; the eval
        # over every live kernel, or over the lists
        surv = ref.survivors(p, blocks, live if in_graph else lists.to(dev))
        sweep = ref.near(p, blocks) if in_graph else surv
        evl = live if in_graph else surv
        per_end.append((sweep.sum(1).cpu().numpy(), evl.sum(1).cpu().numpy(),
                        np.array(ref.cull_counts(p, blocks, sweep))))
    rows = [[n_pix] + [0.5 * (per_end[0][i][b] + per_end[1][i][b])
                       for i in range(3)] for b in range(n_blocks)]
    d, c = 2, image.shape[-1]
    return {"blocks": rows, "f": d * d + d + 1, "e": d + 1, "c": c,
            "in_graph_ukl": in_graph}
