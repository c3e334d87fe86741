"""Driver of the serving-decode cells: `codec.serve.decode_bitstream`, the
one-call decode `cli.decode` runs, from `.smoe` bytes to a float image on
the host.

Set-up: a pool of `.smoe` files under the run's temporary directory, their
params drawn from the seed in the configuration's shapes (the grid
initialisation of the configuration's image, the steering's correlations
and the slopes perturbed), quantized and written by the port's
`quantize_params` and `write_bitstream` at the default bit depths; then
the mix's warm decodes.  Window: one client in a closed loop, each request
a file of the pool in seeded order, timed from the call to the image on
the host.  A sample of the requests the window finished, drawn from the
seed (a reservoir over the requests as they finish) keeps its image, and
so does the last; once the window has closed the reference dequantizes the benchmark's own
params (`reference/quantize_ref.py`) and decodes them, and every kept image
is compared with it in units of the output's least significant bit.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from reference import quantize_ref as Q  # noqa: E402
from reference import smoe_ref as R  # noqa: E402
from yardstick import card, content, trace as tr  # noqa: E402


def pool_params(cfg: dict, seed: int, count: int):
    """`count` param dicts (the names `quantize_params` takes): the grid
    initialisation of the seed's image, its correlations and slopes drawn
    anew for each file."""
    image = content.build(cfg["content"], seed)
    init = R.grid_init(image, int(cfg["kernels_per_dim"]))
    A = init["A"]
    d = A.shape[1]
    diag = np.zeros_like(A)
    diag[:, np.arange(d), np.arange(d)] = A[:, np.arange(d), np.arange(d)]
    out = []
    for i in range(count):
        rng = np.random.default_rng([seed, i])
        out.append({
            "pis": init["pis"], "musX": init["musX"], "A_diagonal": diag,
            "A_corr": np.tril(A, -1) + np.tril(rng.normal(
                0, float(cfg["decode_corr_sd"]), A.shape), -1)
            .astype(np.float32),
            "nu_e": init["nu_e"],
            "gamma_e": rng.normal(0, float(cfg["decode_slope_sd"]),
                                  init["gamma_e"].shape).astype(np.float32)})
    return out, image.shape


def run(ctx: dict) -> dict:
    cfg, mix, dev = ctx["cfg"], ctx["traffic"], torch.device(ctx["device"])
    faults = ctx["faults"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from smoe_tpu_torch.codec import serve
    from smoe_tpu_torch.codec.bitstream import load_native, write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params
    from smoe_tpu_torch.config import SmoeConfig

    t_imp = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"native range coder loaded: {load_native() is not None}",
          file=sys.stderr)
    n_files = int(mix["pool_files"])
    params, shape = pool_params(cfg, ctx["seed"], n_files)
    h, w, c = shape
    kpd = int(cfg["kernels_per_dim"])
    pcfg = SmoeConfig(kernels_per_dim=(kpd, kpd), use_yuv=bool(cfg["use_yuv"]),
                      use_determinant=bool(cfg["use_determinant"]),
                      precision=int(cfg["precision"]),
                      bit_depths=tuple(cfg["codec"]["bit_depths"]))
    tmp = tempfile.mkdtemp(prefix="smoe_bench_")
    try:
        paths = []
        for i, p in enumerate(params):
            path = os.path.join(tmp, f"pool{i}.smoe")
            write_bitstream(path, quantize_params(p, pcfg), pcfg, extra={
                "shape_of_img": [h, w], "dim_of_output": c,
                "use_yuv": bool(cfg["use_yuv"]),
                "use_determinant": bool(cfg["use_determinant"]),
                "train_gammas": True})
            paths.append(path)
        ctx["marks"] = [("imports", t_imp - ctx["t_start"]),
                        ("pool written", time.perf_counter() - t_imp)]
        m = _serve(ctx, serve, paths, dev, faults)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    m["checks"], m["decode_work"] = check(ctx, params, (h, w), m.pop("kept"),
                                          "fp32")
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return m


def _serve(ctx, serve, paths, dev, faults) -> dict:
    mix = ctx["traffic"]
    n_files = len(paths)
    rng = np.random.default_rng(ctx["seed"])
    order = rng.integers(0, n_files, size=1 << 16)
    pick = np.random.default_rng([ctx["seed"], 1])
    n_keep = int(mix["sample_requests"])
    span = contextlib.nullcontext
    if ctx["trace"]:
        _spans(serve)
        span = torch.profiler.record_function
    decode = serve.decode_bitstream
    if faults:
        decode = _faulty(decode, faults)
    for i in range(int(mix["warm_decodes"])):
        decode(paths[i % n_files], device=dev)
    parse_ms = []
    if ctx["trace"]:
        # the parse alone, apart from the requests
        for rep in range(2):
            for path in paths:
                t = card.clock(dev)
                serve.read_model(path)
                parse_ms.append((time.perf_counter() - t) * 1e3)

    lat, slots, last = [], [], []

    def window():
        t0 = card.clock(dev)
        i = 0
        while True:
            f = int(order[i])
            t = time.perf_counter()
            with span("bench.request"):
                img = decode(paths[f], device=dev)
            lat.append(time.perf_counter() - t)
            # a reservoir: every finished request is kept with the same
            # chance, n_keep / (i + 1)
            if i < n_keep:
                slots.append((i, f, img))
            else:
                j = int(pick.integers(0, i + 1))
                if j < n_keep:
                    slots[j] = (i, f, img)
            last[:] = [i, f, img]
            i += 1
            if time.perf_counter() - t0 >= ctx["seconds"]:
                return time.perf_counter() - t0

    t_open = card.clock(dev)
    setup_s = t_open - ctx["t_start"]
    print("setup: " + ", ".join(f"{n} {v:.2f} s" for n, v in ctx["marks"])
          + f", warm decodes {setup_s - sum(v for _, v in ctx['marks']):.2f}"
          " s", file=sys.stderr)
    if ctx["trace"]:
        sl = tr.profiled(window, dev)
        window_s = sl.window_s
    else:
        window_s = window()
    kept = {i: (f, img) for i, f, img in slots}
    kept[last[0]] = (last[1], last[2])     # the last request is always kept
    m = {"end_to_end": {"decode_ms.p95": float(np.percentile(lat, 95))
                        * 1e3, "setup_s": setup_s},
         "requests": len(lat), "parse_ms": parse_ms,
         "attempted": len(lat), "failed": 0, "kept": kept,
         "request_files": [int(f) for f in order[:len(lat)]]}
    q = np.percentile(lat, [50, 90, 95, 99, 100]) * 1e3
    print("look: latency ms p50 p90 p95 p99 max " + " ".join(
        f"{v:.1f}" for v in q) + "; mean by file " + " ".join(
        f"{np.mean([x for x, f in zip(lat, order) if f == i]) * 1e3:.1f}"
        for i in range(n_files)), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    m["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": card.card_fields(dev)["card"], "count": 1,
                   "memory_peak_bytes": int(peak)}
    m["power_limit_w"] = card.card_fields(dev)["power_limit_w"]
    if ctx["trace"]:
        m["slice"] = sl
        m["device"]["busy_s"] = tr.busy_s(sl)
        m["device"]["window_s"] = sl.window_s
        m["breakdown"] = {"device_ops": tr.top_ops(sl),
                          "idle_gaps": tr.idle_gaps(sl)}
    return m


def _spans(serve) -> None:
    """Name the parse and the decoder's set-up in a traced run's trace:
    `decode_bitstream` calls both through the module, so a range around
    each is taken from outside the program."""
    for name, span in (("read_model", "bench.parse"),
                       ("make_decoder", "bench.decoder")):
        fn = getattr(serve, name)
        if getattr(fn, "bench_span", None):
            continue

        def wrapped(*a, _fn=fn, _span=span, **k):
            with torch.profiler.record_function(_span):
                return _fn(*a, **k)
        wrapped.bench_span = span
        setattr(serve, name, wrapped)


def _faulty(decode, faults):
    """decode_bitstream with a planted fault: "stale" returns the previous
    request's image, "altered" zeroes one row of the image it returns."""
    last = {}

    def wrapped(path, **kw):
        img = decode(path, **kw)
        if faults.get("stale") and "img" in last:
            img, last["img"] = last["img"], img
        else:
            last["img"] = img
        if faults.get("altered"):
            img = img.copy()
            img[img.shape[0] // 2] = 0.0
        return img
    return wrapped


def check(ctx, params, shape, kept, precision: str):
    """(the numbers that decide `correct`, the work of each file's K1
    launch): the kept images against the reference's decode of the same
    file, in least significant bits of the output."""
    cfg = ctx["cfg"]
    dev = torch.device(ctx["device"])
    ref = R.Ref({"precision": int(cfg["precision"]), "use_yuv": cfg["use_yuv"],
                 "use_determinant": cfg["use_determinant"]}, precision)
    qcfg = Q.codec_cfg(**cfg["codec"])
    steps = 2 ** int(cfg["precision"]) - 1
    worst, off, total = 0.0, 0, 0
    refs, survivors = {}, {}
    dqs = [Q.rescaler(Q.quantize_params(p, qcfg), qcfg) for p in params]
    if ctx["trace"]:
        survivors = {f: (int(dq["pis"].shape[0]), _cull(dq, shape, dev, int(cfg["precision"])))
                     for f, dq in enumerate(dqs)}
    for i, (f, img) in sorted(kept.items()):
        if f not in refs:
            refs[f] = R.decode(ref, dqs[f], shape, dev).cpu().numpy()
        lsb = np.abs(np.rint(img.astype(np.float64) * steps)
                     - np.rint(refs[f].astype(np.float64) * steps))
        worst = max(worst, float(lsb.max()))
        off += int((lsb > 0).sum())
        total += lsb.size
    print(f"look: compared {len(kept)} images, requests "
          + " ".join(str(i) for i in sorted(kept)), file=sys.stderr)
    checks = {"max_lsb": worst, "off_share": off / max(total, 1)}
    return checks, {"files": survivors, "pixels": int(np.prod(shape))}


def _cull(dq, shape, dev, bits: int, rows: int = 1 << 16) -> int:
    """The (pixel, kernel) pairs of the decode that pass the cull, counted
    by the reference at fp32."""
    r32 = R.Ref({"precision": bits})
    p = {f: torch.as_tensor(np.asarray(dq[f], np.float32), device=dev)
         for f in ("musX", "nu_e", "gamma_e", "pis")}
    A = torch.as_tensor(np.asarray(dq["A"], np.float32), device=dev)
    axes = [torch.as_tensor(np.linspace(0.0, 1.0, s).astype(np.float32),
                            device=dev) for s in shape]
    x = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    mask = p["pis"] > 0
    n = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], rows):
            n += int((r32.gate(p, x[i:i + rows], mask, A=A) > 0).sum())
    return n
