"""Smoke run of the PyTorch port's serving decode on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `smoe_tpu_torch` end to end on the card and fails (non-zero exit,
no result line) on any fault:
  1. the card (nvidia-smi name and power limit), torch / CUDA versions,
     TF32 flags (both forced off);
  2. builds the Hopper gate+expert kernel (K1) from
     smoe_tpu_torch/kernels/csrc/gate_expert_fwd.cu with nvcc;
  3. holds the kernel against its plain torch version at three shapes
     (the 512^2 x 256-kernel flagship, d = 4, K = 2304): res <= 1e-5
     absolute, surv <= 1e-6;
  4. decodes the committed fixture tests/data/bench512_k256.smoe (written
     by the JAX package, scripts/make_torch_fixture.py) natively, at
     scale 2 and in a window, through the kernel; checks the kernel ran,
     that the decode is within 1 LSB of the plain-torch decode (>= 99.9 %
     of pixels identical) and of the JAX decode recorded beside the
     fixture, and that its PSNR is within 0.01 dB of the recorded one;
  5. encodes a seeded 3840x2160 RGB model with 48x48 = 2304 kernels with
     the port's own init, quantizer and bitstream writer, decodes it on the
     card through the kernel and checks it against the plain version on a
     strided row subset.
Then prints the card line, one JSON line of kernel results, and
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "data", "bench512_k256.smoe")
FIXTURE_REF = os.path.join(HERE, "tests", "data", "bench512_k256_ref.npz")
RES_TOL, SURV_TOL = 1e-5, 1e-6
KERNEL_SRC = "smoe_tpu_torch/kernels/csrc/gate_expert_fwd.cu"
KERNEL_REPLACES = "smoe_tpu/kernels/gate_expert.py:113"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms_median(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median wall milliseconds of fn, which ends in a host copy."""
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def lsb_stats(a: np.ndarray, b: np.ndarray):
    """(max |diff| in 8-bit LSB, share of identical 8-bit values)."""
    ua = np.uint8(np.round(a * 255)).astype(np.int32)
    ub = np.uint8(np.round(b * 255)).astype(np.int32)
    return int(np.abs(ua - ub).max()), float(np.mean(ua == ub))


def random_case(n, k, d, e, c, seed, device):
    """Kernel inputs shaped like a real model: steered Gaussians with
    centers in [0,1]^d, some dead (pi_det = 0) and some masked kernels."""
    import torch
    from smoe_tpu_torch.core.model import kernel_quadratics, \
        quadratic_features
    rng = np.random.default_rng(seed)
    kpd = max(2.0, k ** (1.0 / d))
    A = np.zeros((k, d, d), np.float32)
    idx = np.arange(d)
    A[:, idx, idx] = rng.uniform(1.0, 3.0, (k, d)) * 2 * (kpd + 1)
    A += np.tril(rng.normal(0, 0.3 * kpd, (k, d, d)), -1).astype(np.float32)
    mus = rng.uniform(0, 1, (k, d)).astype(np.float32)
    coords = rng.uniform(0, 1, (n, d)).astype(np.float32)
    pis = rng.uniform(0.5, 1.5, k).astype(np.float32) / k
    pis[rng.uniform(size=k) < 0.1] = 0.0                      # dead
    mask = (rng.uniform(size=k) > 0.1).astype(np.float32)     # masked
    det = np.prod(A[:, idx, idx], -1) / math.sqrt((2 * math.pi) ** d)
    pi_det = (pis * det * mask).astype(np.float32)
    G = rng.normal(0, 0.3, (k, e * c)).astype(np.float32)
    G[:, -c:] += 0.5
    t = lambda x: torch.as_tensor(x, device=device)           # noqa: E731
    At = t(A)
    B = (At[:, :, None, :] * At[:, None, :, :]).sum(-1)
    q = kernel_quadratics(B, t(mus)).contiguous()
    x = t(coords)
    phi = quadratic_features(x).contiguous()
    xe = (torch.cat([x, torch.ones((n, 1), device=device)], 1)
          if e == d + 1 else torch.ones((n, 1), device=device)).contiguous()
    return phi, xe, q, t(G), t(pi_det), t(mask)


def compare_kernel(name, n, k, d, e, c, seed, thr, floor, time_it):
    import torch
    from smoe_tpu_torch.kernels.gate_expert import (gate_expert_fwd,
                                                    gate_expert_reference)
    args = random_case(n, k, d, e, c, seed, "cuda")
    res_k, surv_k = gate_expert_fwd(*args, thr, floor)
    torch.cuda.synchronize()
    res_p, surv_p = gate_expert_reference(*args, thr, floor)
    d_res = (res_k - res_p).abs().amax(1)
    d_surv = (surv_k - surv_p).abs()
    # a pair whose plain weight sits within 1e-5 relative of the cull
    # threshold may land on the other side in the kernel (fp32 rounding
    # of a different summation order); such flips are counted, never
    # absorbed into the tolerance
    phi, xe, q, G, pi_det, mask = args
    maha = torch.clamp(phi @ q.T, min=0.0)
    n_w = torch.exp(-0.5 * (maha * mask[None, :])) * pi_det[None, :]
    w = n_w / torch.clamp(n_w.sum(1, keepdim=True), min=floor)
    near = (w - thr).abs() <= 1e-5 * thr
    bad_rows = d_res > RES_TOL
    flip_pairs = int(near[bad_rows].sum())
    unexplained = int((bad_rows & ~near.any(1)).sum())
    bad_k = d_surv > SURV_TOL
    unexplained_k = int((bad_k & ~near.any(0)).sum())
    out = {"shape": name, "n": n, "k": k, "f": phi.shape[1], "e": e,
           "c": c, "max_abs_err_res": float(d_res.max()),
           "max_abs_err_surv": float(d_surv.max()),
           "rows_over_tol": int(bad_rows.sum()),
           "cull_flip_pairs": flip_pairs,
           "survivor_flags_equal": bool(torch.equal(surv_k > 0,
                                                    surv_p > 0))}
    del maha, n_w, w, near
    if time_it:
        out["ms"] = cuda_ms(lambda: gate_expert_fwd(*args, thr, floor), 20)
        out["plain_ms"] = cuda_ms(
            lambda: gate_expert_reference(*args, thr, floor), 5)
    print(f"kernel-vs-plain {json.dumps(out)}", flush=True)
    check(torch.isfinite(res_k).all().item(), f"{name}: non-finite res")
    check(unexplained == 0 and unexplained_k == 0,
          f"{name}: {unexplained} rows / {unexplained_k} kernels exceed "
          f"res {RES_TOL} / surv {SURV_TOL} without a cull flip")
    check(out["rows_over_tol"] <= 1e-4 * n,
          f"{name}: {out['rows_over_tol']} rows over tolerance")
    return out


def build_4k_image(h=2160, w=3840, seed=0):
    """Seeded smooth + edged RGB test image (bench.build_image's recipe at
    4K), float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y /= h - 1
    x /= w - 1
    img = np.stack([
        0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
        0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
        0.4 + 0.3 * np.sin(5 * x * y),
    ], axis=-1)
    img[h // 4:h // 2, w // 3:w // 2, 0] += 0.2
    img[h // 2:, : w // 4, 1] -= 0.15
    img += rng.normal(0, 0.005, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from bench import build_image
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params
    from smoe_tpu_torch.codec.serve import (decode_bitstream, make_decoder,
                                            pad_decoded_params, read_model,
                                            sample_grid)
    from smoe_tpu_torch.config import SmoeConfig
    from smoe_tpu_torch.core.init import init_params
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.kernels import build
    from smoe_tpu_torch.kernels.gate_expert import gate_expert_fwd

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # phase 2: build
    b = build.build("gate_expert_fwd")
    print(f"build: {b['path']} built={b['built']} in {b['seconds']:.2f} s",
          flush=True)
    for line in b["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 3: kernel against plain at three shapes
    thr, floor = 0.5 / 2 ** 8, 1e-11
    flagship = compare_kernel("flagship 512^2 x K256 d2", 512 * 512, 256, 2,
                              3, 3, 1, thr, floor, time_it=True)
    d4 = compare_kernel("d4 F21", 40009, 300, 4, 5, 3, 2, thr, floor,
                        time_it=False)
    k2304 = compare_kernel("K2304 d2", 3840 * 17 + 5, 2304, 2, 3, 3, 3, thr,
                           floor, time_it=True)
    max_err = max(o["max_abs_err_res"] for o in (flagship, d4, k2304))

    # phase 4: the main path on the committed fixture
    ref = np.load(FIXTURE_REF)
    stride = int(ref["stride"])
    roi = ((96, 352), (160, 480))
    gate_expert_fwd.launches = 0
    rec = decode_bitstream(FIXTURE, device="cuda")
    rec2 = decode_bitstream(FIXTURE, scale=2.0, device="cuda")
    rec_roi = decode_bitstream(FIXTURE, roi=roi, device="cuda")
    launches = gate_expert_fwd.launches
    print(f"fixture decode: launches={launches} shapes {rec.shape} "
          f"{rec2.shape} {rec_roi.shape}", flush=True)
    check(launches == 3, f"fixture decode launched the kernel {launches} "
          "times, expected 3")
    for name, r, shape in (("native", rec, (512, 512, 3)),
                           ("scale2", rec2, (1024, 1024, 3)),
                           ("roi", rec_roi, (256, 320, 3))):
        check(r.shape == shape and np.isfinite(r).all()
              and r.min() >= 0 and r.max() <= 1,
              f"{name}: bad output {r.shape}")
        plain = decode_bitstream(FIXTURE, device="cuda", reference=True,
                                 scale=2.0 if name == "scale2" else None,
                                 roi=roi if name == "roi" else None)
        lsb, same = lsb_stats(r, plain)
        print(f"  {name}: kernel vs plain-torch on card: max {lsb} LSB, "
              f"{100 * same:.4f} % identical", flush=True)
        check(lsb <= 1 and same >= 0.999, f"{name}: kernel vs plain decode")
    lsb_j, same_j = lsb_stats(rec[::stride, ::stride],
                              ref["sample"].astype(np.float64) / 255)
    img = build_image(512)
    psnr = psnr_from_mse(float(np.mean((rec - img) ** 2)) * 2 ** 16, 8)
    print(f"  native vs recorded JAX decode: max {lsb_j} LSB, "
          f"{100 * same_j:.3f} % identical on the {stride}-strided sample; "
          f"PSNR {psnr:.4f} dB vs JAX {float(ref['psnr_db']):.4f} dB",
          flush=True)
    check(lsb_j <= 1, "native decode differs from JAX by more than 1 LSB")
    check(abs(psnr - float(ref["psnr_db"])) <= 0.01, "PSNR drifted")

    cfg, rp, header = read_model(FIXTURE)
    k = int(rp["pis"].shape[0])
    pad = pad_decoded_params(rp, k, 2, 3)
    pargs = [pad[n] for n in ("A", "musX", "nu_e", "gamma_e", "pis")]
    # host-side share of the end-to-end time: entropy decode + dequantize
    times = {"read_model_512_ms": host_ms_median(lambda: read_model(FIXTURE))}
    for label, kw in (("512", {}), ("1024", {"scale": 2.0})):
        for path in ("kernel", "plain"):
            plain = path == "plain"
            times[f"decode_{label}_{path}_e2e_ms"] = host_ms_median(
                lambda: decode_bitstream(FIXTURE, device="cuda",
                                         reference=plain, **kw))
            sp = sample_grid((512, 512), scale=2.0) if kw else None
            dec = make_decoder((512, 512), 3, cfg, k, sample_points=sp,
                               device="cuda", reference=plain)
            times[f"decode_{label}_{path}_device_ms"] = cuda_ms(
                lambda: dec(*pargs), 5)
    print(f"fixture decode times: {json.dumps(times)}", flush=True)

    # phase 5: 4K x 2304 kernels, encoded by the port itself
    img4k = build_4k_image()
    cfg4k = SmoeConfig(kernels_per_dim=(48, 48), use_yuv=True,
                       use_determinant=True)
    p = init_params(img4k, cfg4k)
    rng = np.random.default_rng(4)
    pdict = {"pis": p.pis, "musX": p.musX, "A_diagonal": p.a_diag,
             "A_corr": p.a_corr + np.tril(rng.normal(
                 0, 10.0, p.a_corr.shape), -1).astype(np.float32),
             "nu_e": p.nu_e,
             "gamma_e": rng.normal(0, 0.1, p.gamma_e.shape).astype(
                 np.float32)}
    qp = quantize_params(pdict, cfg4k)
    with tempfile.TemporaryDirectory() as tmp:
        path4k = os.path.join(tmp, "uhd_k2304.smoe")
        bits = write_bitstream(path4k, qp, cfg4k, extra={
            "shape_of_img": [2160, 3840], "dim_of_output": 3,
            "use_yuv": True, "use_determinant": True, "train_gammas": True})
        gate_expert_fwd.launches = 0
        t0 = time.perf_counter()
        rec4k = decode_bitstream(path4k, device="cuda")
        first_ms = (time.perf_counter() - t0) * 1e3
        launches4k = gate_expert_fwd.launches
        launches += launches4k
        check(launches4k == 1, f"4K decode launched {launches4k} kernels")
        check(rec4k.shape == (2160, 3840, 3) and np.isfinite(rec4k).all(),
              f"4K decode: bad output {rec4k.shape}")
        cfg4, rp4, _ = read_model(path4k)
        pad4 = pad_decoded_params(rp4, 2304, 2, 3)
        args4 = [pad4[n] for n in ("A", "musX", "nu_e", "gamma_e", "pis")]
        rows = np.linspace(0, 1, 2160, dtype=np.float32)[::64]
        cols = np.linspace(0, 1, 3840, dtype=np.float32)
        sub_plain = make_decoder(None, 3, cfg4, 2304,
                                 sample_points=(rows, cols), device="cuda",
                                 reference=True)(*args4).cpu().numpy()
        lsb4, same4 = lsb_stats(rec4k[::64], sub_plain)
        dec4 = make_decoder((2160, 3840), 3, cfg4, 2304, device="cuda")
        t4 = {"encode_payload_bits": bits,
              "read_model_4k_ms": host_ms_median(lambda: read_model(path4k)),
              "decode_4k_kernel_first_e2e_ms": first_ms,
              "decode_4k_kernel_e2e_ms": host_ms_median(
                  lambda: decode_bitstream(path4k, device="cuda")),
              "decode_4k_kernel_device_ms": cuda_ms(lambda: dec4(*args4), 5)}
        dec4_plain = make_decoder((2160, 3840), 3, cfg4, 2304,
                                  device="cuda", reference=True)
        t4["decode_4k_plain_device_ms"] = cuda_ms(lambda: dec4_plain(*args4),
                                                  1, warmup=1)
    print(f"4K decode: 2160x3840 x 2304 kernels, kernel vs plain on "
          f"{rows.size} strided rows: max {lsb4} LSB, "
          f"{100 * same4:.4f} % identical; {json.dumps(t4)}", flush=True)
    check(lsb4 <= 1 and same4 >= 0.999, "4K kernel vs plain decode")

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "gate_expert_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
