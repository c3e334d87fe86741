"""K1 and K2 against the versions of an earlier commit, on one NVIDIA GPU:
outputs bit for bit, and times taken in turns.

    mkdir -p _parent && git archive <commit> smoe_tpu_torch/kernels/csrc \
        | tar -x -C _parent
    python3 scripts/compare_parent_kernels.py \
        _parent/smoe_tpu_torch/kernels/csrc [--quick] [--with-denom]

The earlier csrc/gate_expert_fwd.cu and gate_expert_bwd.cu are built with
nvcc into <csrc>/../build_parent and called with ctypes beside the current
kernels, on the same tensors.  Their C interface is the one they had up to
commit dc29662 (no denominator buffer, no stats), or with --with-denom the
current one (K1 writes the denominator and stats, K2 reads it), as from
commit 325de62 on.  Cases:

  * phase 3's three shapes of chip_smoke.py (`random_case`: pixels drawn
    at random, so a CTA's pixels are scattered and nearly every kernel is a
    candidate of K1's second pass);
  * raster-ordered operands: the flagship fit's block after 20 sweeps
    (chip_smoke.py phase 8) and the 4K x 2304-kernel decode (phase 7);
  * with --large-k, K = 16384 (40009 pixels) and K = 50000 (4099 pixels),
    `random_case` as phase 3 draws them: several of the current K1's
    segments of 8192 kernels against an earlier one-segment K1 (which
    holds at most 53,236 kernels at d = 2).

For each case: K1's res and surv, and K2's dq', dG and dpi (the current K2
fed the current K1's denominator, as the trainer feeds it), compared bit
for bit with the earlier kernels'; then each kernel timed with CUDA events
old, new, new, old (each reading the mean over `reps` launches, both
through the same thin call of the C interface), with K1's candidate
fraction.  --quick skips the timing and the raster cases.  Prints
the card, the F = 26 instances' ptxas registers and spills of both
builds, and one JSON line per case; --json FILE also writes them all
there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_parent(csrc: str, with_denom: bool) -> dict:
    """nvcc the earlier fwd and bwd sources with the current flags."""
    from smoe_tpu_torch.kernels import build
    out_dir = os.path.join(os.path.dirname(os.path.abspath(csrc)),
                           "build_parent")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in ("gate_expert_fwd", "gate_expert_bwd"):
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, name + ".cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
        # the F = 26 instances' registers, spills and shared memory, as
        # chip_smoke.build_all prints the current ones
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "Li26E" in line:
                entry = line.split("_cu_")[-1].split("EEv")[0]
                print(f"  earlier ptxas F26 {entry}: " + " | ".join(
                    x.replace("ptxas info    :", "").strip()
                    for x in lines[i + 2:i + 4]), flush=True)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = libs["gate_expert_fwd"], libs["gate_expert_bwd"]
    extra = 2 if with_denom else 0
    fwd.smoe_gate_expert_fwd.argtypes = [ptr] * (7 + extra) + [i32] * 5 + [
        f32, f32, ptr]
    fwd.smoe_gate_expert_fwd.restype = i32
    bwd.smoe_gate_expert_bwd.argtypes = [ptr] * (9 + extra // 2) + [
        i32] * 5 + [f32, f32, ptr, ptr]
    bwd.smoe_gate_expert_bwd.restype = i32
    bwd.smoe_gate_expert_bwd_workspace.argtypes = [i32] * 5
    bwd.smoe_gate_expert_bwd_workspace.restype = ctypes.c_longlong
    return libs


def k1_call(lib, phi, xe, q, G, pi_det, mask, thr, floor, extra=()):
    """K1 through the C interface `lib` exports, with the wrapper's
    prescale and outputs and no checks: the earlier interface as it is,
    the current one with `extra` = its (den_out, stats) pointers.  Both
    kernels are timed through this one thin path, so the host work around
    a launch is the same for both and a slow host cannot favour either."""
    import torch
    n, f = phi.shape
    e, k = xe.shape[1], q.shape[0]
    c = G.shape[1] // e
    q_s = (q * (-0.5 * mask)[:, None]).contiguous()
    res = torch.empty((n, c), dtype=torch.float32, device=phi.device)
    surv = torch.zeros((k,), dtype=torch.float32, device=phi.device)
    err = lib.smoe_gate_expert_fwd(
        phi.data_ptr(), xe.data_ptr(), q_s.data_ptr(), G.data_ptr(),
        pi_det.data_ptr(), res.data_ptr(), surv.data_ptr(), *extra, n, f, e,
        c, k, thr, floor, torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"K1 launch failed ({err})")
    return res, surv


def k2_call(lib, phi, xe, q_s, G, pi_det, g, thr, floor, extra=()):
    """K2 through `lib`'s C interface, as k1_call; `extra` = the current
    interface's (den,) pointer."""
    import torch
    n, f = phi.shape
    e, k, c = xe.shape[1], q_s.shape[0], g.shape[1]
    dev = phi.device
    dq = torch.empty((k, f), dtype=torch.float32, device=dev)
    dG = torch.empty((k, e * c), dtype=torch.float32, device=dev)
    dpi = torch.empty((k,), dtype=torch.float32, device=dev)
    ws = torch.empty((int(lib.smoe_gate_expert_bwd_workspace(n, f, e, c,
                                                             k)),),
                     dtype=torch.float32, device=dev)
    err = lib.smoe_gate_expert_bwd(
        phi.data_ptr(), xe.data_ptr(), q_s.data_ptr(), G.data_ptr(),
        pi_det.data_ptr(), g.data_ptr(), *extra, dq.data_ptr(),
        dG.data_ptr(), dpi.data_ptr(), n, f, e, c, k, thr, floor,
        ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"K2 launch failed ({err})")
    return dq, dG, dpi


def in_turns(old, new, reps):
    """(old ms, new ms, the four readings), taken old, new, new, old."""
    (a, ra), (b, rb) = cs.in_turns(lambda: cs.cuda_ms(old, reps),
                                   lambda: cs.cuda_ms(new, reps))
    return a, b, [ra[0], rb[0], rb[1], ra[1]]


def compare_case(libs, name, fargs, thr, floor, seed, reps,
                 with_denom=False):
    import torch
    from smoe_tpu_torch.kernels import gate_expert as ge
    phi, xe, q, G, pi_det, mask = fargs
    n, k, c = phi.shape[0], q.shape[0], G.shape[1] // xe.shape[1]
    lf, lb = libs["gate_expert_fwd"], libs["gate_expert_bwd"]
    nf, nb = ge._library(), ge._bwd_library()
    den = torch.empty((n,), dtype=torch.float32, device="cuda")
    new_res, new_surv = ge.gate_expert_fwd(*fargs, thr, floor,
                                           denom_out=den)
    old_fx = (None, None) if with_denom else ()
    o_res, o_surv = k1_call(lf, *fargs, thr, floor, old_fx)
    q_s = (q * (-0.5 * mask)[:, None]).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((n, c), generator=gen, device="cuda") / n
    args = (phi, xe, q_s, G, pi_det, g, thr, floor)
    new_b = ge.gate_expert_bwd(*args, denom=den)
    old_bx = (den.data_ptr(),) if with_denom else ()
    o_b = k2_call(lb, *args, old_bx)
    torch.cuda.synchronize()
    out = {"case": name, "n": n, "k": k, "f": phi.shape[1],
           "k1_res_bit_identical": bool(torch.equal(new_res, o_res)),
           "k1_surv_bit_identical": bool(torch.equal(new_surv, o_surv)),
           "k1_res_max_abs_diff": float((new_res - o_res).abs().max()),
           "k2_bit_identical": all(torch.equal(a, b)
                                   for a, b in zip(new_b, o_b)),
           "k2_max_abs_diff": max(float((a - b).abs().max())
                                  for a, b in zip(new_b, o_b))}
    del new_res, new_surv, o_res, o_surv, new_b, o_b
    out["candidate_fraction"], out["survivors"] = cs.k1_stats(fargs, thr,
                                                              floor)
    if reps:
        out["k1_old_ms"], out["k1_new_ms"], out["k1_readings_ms"] = in_turns(
            lambda: k1_call(lf, *fargs, thr, floor, old_fx),
            lambda: k1_call(nf, *fargs, thr, floor, (None, None)), reps)
        out["k2_old_ms"], out["k2_new_ms"], out["k2_readings_ms"] = in_turns(
            lambda: k2_call(lb, *args, old_bx),
            lambda: k2_call(nb, *args, (den.data_ptr(),)), max(1, reps // 2))
    print(f"parent-vs-new {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("csrc", help="the earlier commit's kernels/csrc folder")
    p.add_argument("--quick", action="store_true",
                   help="bits only, at phase 3's shapes")
    p.add_argument("--with-denom", action="store_true",
                   help="the earlier kernels take the denominator buffer")
    p.add_argument("--large-k", action="store_true",
                   help="also K = 16384 and K = 50000")
    p.add_argument("--json", metavar="FILE",
                   help="write the card and every case there as JSON")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_parent_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cs.build_all()
    libs = build_parent(a.csrc, a.with_denom)
    cases = [("flagship 512^2 x K256 d2", 512 * 512, 256, 2, 3, 1, 20),
             ("d4 F21", 40009, 300, 4, 5, 2, 20),
             ("K2304 d2", 3840 * 17 + 5, 2304, 2, 3, 3, 10)]
    if a.large_k:
        cases += [("K16384 d2", 40009, 16384, 2, 3, 5, 5),
                  ("K50000 d2", 4099, 50000, 2, 3, 6, 5)]
    thr, floor = 0.5 / 2 ** 8, 1e-11
    results = []
    for name, n, k, d, e, seed, reps in cases:
        fargs = cs.random_case(n, k, d, e, 3, seed, "cuda")
        results.append(compare_case(libs, name, fargs, thr, floor, seed,
                                    0 if a.quick else reps, a.with_denom))
    if not a.quick:
        import tempfile
        from bench import build_image
        s = cs.flagship_smoe(build_image(512), "auto")
        s.run_batched_chunk(cs.FIT_SWEEPS)
        *fargs, thr_f, floor_f = cs.trainer_kernel_args(s)
        del s
        results.append(compare_case(libs, "flagship fit, sweep 20", fargs,
                                    thr_f, floor_f, 8, 20, a.with_denom))
        del fargs
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "uhd_k2304.smoe")
            cs.write_uhd_model(path)
            *fargs, thr_u, floor_u = cs.decode_kernel_args(path)
        results.append(compare_case(libs, "4K decode 2160x3840 x K2304",
                                    fargs, thr_u, floor_u, 7, 3,
                                    a.with_denom))
    if a.json:
        with open(a.json, "w") as fd:
            json.dump({"card": card, "cases": results}, fd, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
