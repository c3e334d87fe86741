"""Driver of the video fit cell: the production CIF video encode's fit,
`Smoe.train` through the reseed era as `cli.fit` runs it (cli/fit.py:
337-375; the recipe of bench/video_quality.py:fit_argv with -lsinit
kernel -lsri 100 -lsrip initial, in-graph lists, probe threshold 100,
probe grid 5 and 16 blocks).

Set-up: the configuration's clip from the seed as `cli.fit` reads it, the
dual model on it (`Smoe(vol, affines=...)`), the LS initialisation, the
initial fit with its LS refresh, a fresh Adam at lr_div / 10, then for
each time slab the reseed, its LS refit and a retrain, then the first
checked stage, then one warm call of the window's size.  The warm call
is for the lists, not the graphs: the first call after the reseeds reads
~3 ms a sweep slower than the next ones (wider lists), enough to put a
window of 500-sweep calls near the width at which two calls fill it
instead of three.  The in-graph refresh moves the capped width all
through the fit, so the window still captures graphs at some new widths.
Window: `train` calls of the mix's size, no LS refresh, until `--seconds`
have passed, timed at call boundaries.  With --trace 1 one more call runs
under the profiler, and
the set-up's last slab (its reseed and LS refit) under a second one.
Then the second checked stage, from the state the window ended in.

A checked stage is `train(1)` and `train(2)` with the window's own
arguments, with the state before each of their three sweeps: the params,
Adam's state and the lists the sweep reads.  The reference
(`reference/smoe_video_ref.py`) follows each sweep from that state, not
from its own last sweep: the model is discontinuous (a kernel in or out
of a list, live or dead under the quantised pi, moves a well-fitted
volume's loss by percents), so a reference that drifts a sweep's worth of
rounding from the program crosses such an edge now and then, and every
gap would then measure the edge rather than the program.  Its numbers,
each the worst sweep's: `loss_gap`, `grad_gap` and `step_gap` (a sweep's
Adam step) as the fit cells read them (drivers/fit.py); `lists_diff`, the
entries in which the program's lists and the reference's differ: the
probe-near set each call's sweeps open with, the in-graph refresh after
each sweep (survivors | probe-near at the program's next params) and the
closing eval's (the survivors of the live kernels).

`fit_work` counts a dual-model pair at f = 13, e = 4, c = 3: the 13
features of one domain, the other 13 of the 26 that K1 and K2 read being
zeros the op multiplies through, work no model needs.  So `fit.k1_roofline`,
`fit.k2_roofline` and `fit.mfu` read the useful share, and a program that
stopped multiplying the zeros would raise them.
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

from drivers import fit as FD  # noqa: E402
from reference import smoe_video_ref as VR  # noqa: E402
from yardstick import card, video_content, trace as tr  # noqa: E402

FIELDS = VR.FIELDS


def ref_cfg(cfg: dict) -> dict:
    return {"precision": int(cfg["precision"]), "use_yuv": cfg["use_yuv"],
            "use_determinant": cfg["use_determinant"],
            "probe_maha": cfg["probe_maha_threshold"]}


def make_trainer(cfg: dict, vol, affines, dev):
    """The dual-model trainer `cli.fit` builds for the recipe, on the fused
    op on any device (its plain versions on the CPU): the chunk replaces
    an eval's survivors by the probe-near set only where it takes the
    fused op, so a CPU run follows the card's lists."""
    from smoe_tpu_torch.config import OptConfig
    from smoe_tpu_torch.fit.trainer import Smoe
    opt = cfg["optimizer"]
    s = Smoe(vol, kernels_per_dim=list(cfg["kernels_per_dim"]),
             affines=affines, init_flag=cfg["init_flag"],
             start_batches=int(cfg["blocks"]),
             opt_cfg=OptConfig(base_lr=opt["base_lr"], lr_div=opt["lr_div"],
                               lr_mult=opt["lr_mult"]),
             use_yuv=bool(cfg["use_yuv"]),
             use_determinant=bool(cfg["use_determinant"]),
             normalize_pis=bool(cfg["normalize_pis"]),
             quantization_mode=int(cfg["quantization_mode"]),
             bit_depths=tuple(cfg["bit_depths"]),
             quantize_pis=bool(cfg["quantize_pis"]),
             num_params_model=int(cfg["num_params_model"]),
             probe_maha_threshold=float(cfg["probe_maha_threshold"]),
             in_graph_ukl=bool(cfg["in_graph_ukl"]),
             probe_grid=int(cfg["probe_grid"]),
             nu_anchor=bool(cfg["nu_anchor"]),
             precision=int(cfg["precision"]), use_pallas="on", device=dev)
    if tuple(s.cfg.block_shape) != tuple(cfg["block_shape"]):
        raise ValueError(f"{cfg['blocks']} blocks cut the volume into "
                         f"{s.cfg.block_shape}, not {cfg['block_shape']}")
    s.set_optimizer()
    return s


def reseed_era_optimizer(cfg: dict):
    from smoe_tpu_torch.config import OptConfig
    opt = cfg["optimizer"]
    return OptConfig(base_lr=opt["base_lr"],
                     lr_div=opt["lr_div"] / cfg["reseed_lr_div_factor"],
                     lr_mult=opt["lr_mult"])


def _fixed(s) -> tuple:
    """(model mask, motion rows) on the host: what a stage does not move."""
    return (s.model_mask.detach().cpu().clone(),
            s.params.motion.detach().cpu().clone())


def _capturing(s) -> bool:
    return (s.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def checked_stage(s, call: dict, control=None) -> dict:
    """`train(1)` and `train(2)` from the trainer's state as it stands,
    with the state before each sweep, taken before each eager sweep and
    each replay of a sweep's graph (never inside a capture, which runs
    nothing): the record the reference follows.  `control` (a `VideoRef`,
    its blocks) makes the record with that reference instead, from the
    same state, and leaves the trainer as it was (the control runs)."""
    mm, motion = _fixed(s)
    rec = {"mask": mm, "motion": motion}
    if control is not None:
        rec.update(simulate(*control, FD._host(s.params), FD._adam(s), mm,
                            motion, call_opt(s)))
        return rec
    states, losses, after = [], [], []

    def snap():
        lists = s._sweep_buffers()[0]
        states.append({"p": FD._host(s.params), "adam": FD._adam(s),
                       "lists": lists.detach().cpu().clone()})

    sweep, chunk, new_graph = s._sweep, s.run_batched_chunk, s._new_graph
    wrapped = []

    def recorded_sweep(*a, **k):
        if not _capturing(s):
            snap()
        return sweep(*a, **k)

    def wrap(g):
        replay = g.replay

        def recorded_replay():
            snap()
            replay()
        g.replay = recorded_replay
        wrapped.append(g)
        return g

    def recording_chunk(*a, **k):
        out = chunk(*a, **k)
        losses.extend(float(v) for v in out[0])
        after.append(FD._lists(s))
        return out

    for g in s._graphs.values():
        wrap(g)
    s._sweep, s.run_batched_chunk = recorded_sweep, recording_chunk
    s._new_graph = lambda fn: wrap(new_graph(fn))
    try:
        s.train(**dict(call, num_iter=1))
        s.train(**dict(call, num_iter=2))
    finally:
        s._sweep, s.run_batched_chunk, s._new_graph = sweep, chunk, new_graph
        for g in wrapped:
            del g.replay
    if len(states) != 3 or len(losses) != 3:
        raise RuntimeError(f"a checked stage ran {len(losses)} sweeps and "
                           f"recorded the state of {len(states)}, not 3")
    rec.update(states=states, losses=losses, after=after,
               closing=FD._lists(s), p3=FD._host(s.params),
               adam3=FD._adam(s))
    return rec


def call_opt(s) -> dict:
    o = s.opt_cfg
    return {"base_lr": o.base_lr, "lr_div": o.lr_div, "lr_mult": o.lr_mult}


def _on_host(d: dict) -> dict:
    return {f: d[f].detach().cpu().clone() for f in FIELDS if f in d}


def simulate(ref, blocks, p0: dict, adam0, mask, motion,
             opt_cfg: dict) -> dict:
    """The record `checked_stage` makes, made by `ref` in the program's
    place from params `p0` and Adam state `adam0`: each call opens with an
    eval over the live kernels, whose survivors the chunk replaces by the
    probe-near set; each sweep's survivors | probe-near under the updated
    params are the next sweep's lists; each call closes with an eval."""
    dev = blocks.coords.device
    m0, v0, t0 = adam0
    put = lambda d: {f: v.to(dev) for f, v in d.items()}  # noqa: E731
    opt = VR.Adam(**opt_cfg, m=put(m0), v=put(v0), t=t0)
    p = VR.params_on({f: v.numpy() for f, v in p0.items()}, mask.numpy(),
                     motion.numpy(), dev)
    zeros = {f: torch.zeros(p[f].shape) for f in FIELDS}
    states, losses, after = [], [], []
    for step in range(3):
        if step in (0, 1):
            cur = ref.near(p, blocks)
        states.append({"p": _on_host(p),
                       "adam": (dict(zeros, **_on_host(opt.m)),
                                dict(zeros, **_on_host(opt.v)), opt.t),
                       "lists": cur.cpu()})
        g, loss, surv = ref.grads(p, blocks, cur)
        losses.append(loss)
        p = dict(p, **opt.step(p, g))
        cur = surv | ref.near(p, blocks)
        if step in (0, 2):
            after.append(cur.cpu())
    live = ref.live(p)[None, :].expand(blocks.count, -1).clone()
    return {"states": states, "losses": losses, "after": after,
            "closing": ref.survivors(p, blocks, live).cpu(),
            "p3": _on_host(p),
            "adam3": (_on_host(opt.m), _on_host(opt.v), opt.t)}


def run(ctx: dict) -> dict:
    cfg, mix, dev = ctx["cfg"], ctx["traffic"], torch.device(ctx["device"])
    faults = ctx["faults"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the control: the reference at a lower precision in the program's
    # place in each checked stage (control_checks)
    low = mix.get("reference_in_place")

    marks = [("start", ctx["t_start"]), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    vol, affines = video_content.build(cfg["content"], ctx["seed"])
    s = make_trainer(cfg, vol, affines, dev)
    marks.append(("clip and trainer", card.clock(dev)))
    FD._plant(s, faults)
    control = (VR.VideoRef(ref_cfg(cfg), low),
               VR.VideoBlocks(vol, cfg["block_shape"], dev,
                              cfg["probe_grid"])) if low else None

    # the recipe's front, in the CLI's order
    s.ls_init_experts(cfg["ls_init"])
    s.train(int(cfg["iterations"]), val_iter=int(cfg["val_iter"]),
            ls_refresh_iter=int(cfg["ls_refresh_iter"]))
    marks.append(("initial fit", card.clock(dev)))
    s.set_optimizer(reseed_era_optimizer(cfg))
    slabs = int(cfg["kernels_per_dim"][2])
    reseed_slice = None
    for kk in range(slabs):
        def reseed(kk=kk):
            s.reseed_time_slab(kk, rng=kk)
            s.ls_init_experts(cfg["ls_init"])
        if ctx["trace"] and kk == slabs - 1:
            reseed_slice = tr.profiled(reseed, dev)
        else:
            reseed()
        s.train(int(cfg["reseed_iterations"]),
                val_iter=int(cfg["reseed_val_iter"]))
    marks.append(("reseeds", card.clock(dev)))
    call = dict(num_iter=int(mix["sweeps_per_call"]),
                val_iter=int(mix["val_iter"]),
                ls_refresh_iter=mix.get("ls_refresh_iter"))
    rec = {"start": checked_stage(s, call, control)}
    marks.append(("checked steps", card.clock(dev)))
    s.train(**call)

    t0 = card.clock(dev)
    marks.append(("warm call", t0))
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
    print("look: window calls %d, ms/sweep by call " % len(per_call)
          + " ".join(f"{v:.4f}" for v in per_call), file=sys.stderr)

    m = {"end_to_end": {"fit_ms_per_sweep": window_s / sweeps * 1e3,
                        "setup_s": setup_s},
         "window_s": window_s, "chunk_s": chunk_s, "sweeps": sweeps,
         "attempted": sweeps, "failed": 0}
    if ctx["trace"]:
        p_a = FD._host(s.params)
        sl = tr.profiled(lambda: s.train(**call), dev)
        m.update(slice=sl, slice_sweeps=call["num_iter"],
                 reseed_slice=reseed_slice,
                 breakdown={"device_ops": tr.top_ops(sl),
                            "idle_gaps": tr.idle_gaps(sl)})
        rec["work"] = (p_a, FD._host(s.params))
    rec["end"] = checked_stage(s, call, control)
    rec["opt"] = call_opt(s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    m["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card.card_fields(dev)["card"],
                   "count": 1, "memory_peak_bytes": int(peak)}
    if ctx["trace"]:
        m["device"]["busy_s"] = tr.busy_s(m["slice"])
        m["device"]["window_s"] = m["slice"].window_s
    m["power_limit_w"] = card.card_fields(dev)["power_limit_w"]
    del s
    FD._unplant()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = VR.VideoRef(ref_cfg(cfg), "fp32")
    blocks = VR.VideoBlocks(vol, cfg["block_shape"], dev, cfg["probe_grid"])
    m["checks"] = check(ref, blocks, rec)
    if ctx["trace"]:
        m["fit_work"] = work(ref, blocks, rec["work"],
                             (rec["end"]["mask"], rec["end"]["motion"]))
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return m


def check(ref, blocks, rec: dict) -> dict:
    """The numbers that decide `correct`, each the worst sweep's of the two
    checked stages (`lists_diff` their sum), the reference following each
    sweep from the state the program started it from."""
    dev = blocks.coords.device
    put = lambda d: {f: v.to(dev) for f, v in d.items()}  # noqa: E731
    gaps = {}
    for name in ("start", "end"):
        st = rec[name]
        mm, motion = st["mask"].numpy(), st["motion"].numpy()
        on = lambda d: VR.params_on(  # noqa: E731
            {f: v.numpy() for f, v in d.items()}, mm, motion, dev)
        S = st["states"]
        nxt = [S[1], S[2], {"p": st["p3"], "adam": st["adam3"]}]
        prog_after = [st["after"][0], S[2]["lists"], st["after"][1]]
        by = {"loss_gap": [], "grad_gap": [], "step_gap": []}
        apart = []
        for i in range(3):
            p = on(S[i]["p"])
            lists = S[i]["lists"].to(dev)
            if i in (0, 1):
                apart.append(int((lists != ref.near(p, blocks)).sum()))
            g, loss, surv = ref.grads(p, blocks, lists)
            m, v, t = S[i]["adam"]
            step = VR.Adam(**rec["opt"], m=put(m), v=put(v), t=t).step(p, g)
            g = _on_host(g)
            gn = {f: float(torch.linalg.vector_norm(g[f].double()))
                  for f in FIELDS}
            med = float(np.median(list(gn.values())))
            keep = [f for f in FIELDS if gn[f] >= 1e-3 * med]
            m1 = nxt[i]["adam"][0]
            g_prog = {f: (m1[f] - FD.BETA1 * m[f]) / (1 - FD.BETA1)
                      for f in FIELDS}
            p0, p1 = S[i]["p"], nxt[i]["p"]
            by["loss_gap"].append(abs(st["losses"][i] - loss) / abs(loss))
            by["grad_gap"].append(FD.leaf_gap(g_prog, g, FIELDS))
            by["step_gap"].append(FD.leaf_gap(
                {f: p1[f] - p0[f] for f in FIELDS},
                {f: step[f].cpu() - p0[f] for f in FIELDS}, keep))
            refreshed = surv | ref.near(on(p1), blocks)
            apart.append(int((prog_after[i] != refreshed.cpu()).sum()))
        p3 = on(st["p3"])
        live = ref.live(p3)[None, :].expand(blocks.count, -1).clone()
        apart.append(int((st["closing"]
                          != ref.survivors(p3, blocks, live).cpu()).sum()))
        out = {k: max(v) for k, v in by.items()}
        out["lists_diff"] = float(sum(apart))
        print(f"look: {name}: by sweep "
              + "; ".join(k + " " + " ".join(f"{x:.3e}" for x in v)
                          for k, v in by.items())
              + "; lists apart " + " ".join(map(str, apart)),
              file=sys.stderr)
        for k, v in out.items():
            gaps.setdefault(k, []).append(v)
    out = {k: max(v) for k, v in gaps.items()}
    out["lists_diff"] = float(sum(gaps["lists_diff"]))
    return out


def work(ref, blocks, ends, fixed) -> dict:
    """What the traced call's kernels had to do, counted by the reference
    from its params at the call's start and end: per block the pixels N,
    the kernels a sweep's K1 and K2 gate over (the probe-near set), those
    the eval gates over (every live kernel) and the pairs S past the cull
    of the sweep, each the mean of the two ends."""
    dev = blocks.coords.device
    mm, motion = fixed
    per_end = []
    for p in ends:
        p = VR.params_on({f: v.numpy() for f, v in p.items()}, mm.numpy(),
                         motion.numpy(), dev)
        sweep = ref.near(p, blocks)
        n_live = int(ref.live(p).sum())
        per_end.append((sweep.sum(1).cpu().numpy(),
                        np.full(blocks.count, n_live),
                        np.array(ref.cull_counts(p, blocks, sweep))))
    n_pix = int(blocks.coords.shape[1])
    rows = [[n_pix] + [0.5 * (per_end[0][i][b] + per_end[1][i][b])
                       for i in range(3)] for b in range(blocks.count)]
    return {"blocks": rows, "f": 13, "e": 4, "c": 3, "in_graph_ukl": True}


def control_checks(cell_name: str, seed: int, device, overrides=None,
                   seconds: float = 0.0) -> dict:
    """The control's numbers: the run of the cell with each checked stage
    made by the TF32 reference from the program's state, held to the fp32
    reference by the same comparison."""
    import run
    ov = dict(overrides or {})
    ov["traffic"] = dict(ov.get("traffic", {}), reference_in_place="tf32")
    out = run.run_cell(cell_name, seed, seconds, False, device=device,
                       overrides=ov)
    return {k: v["value"] for k, v in out["checks"].items()}
