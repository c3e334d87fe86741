"""Record the JAX package's motion-compensated dual-model video fit, its
time-slab reseed and a dual-model `.smoe` with its decode, for the PyTorch
port's video path to be held against where there is no JAX.

    JAX_PLATFORMS=cpu python scripts/make_torch_video_fixture.py

The clip is a cut of the synthetic panning CIF scene of
scripts/bench_video.py (`build_video(texture="synth", moving_obj=True)`):
144 x 176 x 4 RGB instead of 288 x 352 x 8, fitted with
`Smoe(vid, kernels_per_dim=[6, 6, 2], affines=affines, init_flag=1)`
(72 motion-plane + 72 raw-domain rows, YUV loss, determinant gating), the
largest the CPU finishes in about a minute.

Outputs (committed, together under 100 KB):
    tests/data/video_cut_ref.npz
        shape, kernels_per_dim      the cut
        loss, mse, num_pi           run_batched_chunk(20)'s per-sweep metrics
                                    from the init (each describes the
                                    params before its sweep's update)
        lists                       the kernel lists after those sweeps
        p_<field>                   the raw params after them (motion too)
        reseed_rows, reseed_musX    reseed_time_slab(0, rng=0) from there:
                                    the activated rows and their centers
        reseed_num_pi, reseed_mse   live kernels after it, the next sweep's
                                    mse
        stride, sample, psnr_db     the JAX decode of video_cut.smoe, every
                                    `stride`-th pixel of each frame as
                                    uint8, and its PSNR against the clip
    tests/data/video_cut.smoe       the model after the reseed and 5 more
                                    sweeps, quantized and written by the JAX
                                    package with its motion rows and
                                    dual-model mask
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (144, 176, 4)
KPD = (6, 6, 2)
FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e", "motion")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--iters", type=int, default=20)
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "video_cut"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))

    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench_video import build_video
    from smoe_tpu import Smoe
    from smoe_tpu.codec.bitstream import write_bitstream
    from smoe_tpu.codec.quantize import quantize_params
    from smoe_tpu.codec.serve import decode_bitstream
    from smoe_tpu.core.losses import psnr_from_mse

    h, w, t = SHAPE
    vid, affines = build_video(h=h, w=w, t=t, moving_obj=True)
    s = Smoe(vid, kernels_per_dim=list(KPD), affines=affines, init_flag=1,
             use_yuv=True, use_determinant=True)
    s.set_optimizer()
    t0 = time.time()
    loss, mse, num_pi, _ = s.run_batched_chunk(a.iters)
    print(f"fit: {a.iters} sweeps in {time.time() - t0:.1f} s; mse "
          f"{float(mse[0]):.4f} -> {float(mse[-1]):.4f}")
    out = {"shape": np.asarray(SHAPE), "kernels_per_dim": np.asarray(KPD),
           "loss": np.asarray(loss, np.float32),
           "mse": np.asarray(mse, np.float32),
           "num_pi": np.asarray(num_pi, np.int32), "iters": a.iters,
           "lists": np.asarray(s.kernel_lists)}
    for f in FIELDS:
        out["p_" + f] = np.asarray(getattr(s.params, f), np.float32)

    rows = s.reseed_time_slab(0, rng=0)
    out["reseed_rows"] = np.asarray(rows)
    out["reseed_musX"] = np.asarray(s.params.musX)[rows]
    _, rmse, rnpi, _ = s.run_batched(train=True)
    out["reseed_num_pi"], out["reseed_mse"] = int(rnpi), float(rmse)
    print(f"reseed: rows {rows[0]}..{rows[-1]}, live {rnpi}, next mse "
          f"{rmse:.4f}")
    s.run_batched_chunk(4)

    pdict = s.get_params()
    qp = quantize_params(pdict, s.cfg)
    used = np.asarray(qp["used_kernels"], bool)
    extra = {"shape_of_img": list(vid.shape[:-1]),
             "dim_of_output": vid.shape[-1], "use_yuv": s.cfg.use_yuv,
             "use_determinant": s.cfg.use_determinant,
             "train_gammas": s.cfg.train_gammas,
             "motion": np.stack([np.asarray(pdict[k], np.float32) for k in
                                 ("h11", "h12", "h13", "h21", "h22", "h23",
                                  "h31", "h32")]).tolist(),
             "num_params_model": int(s.cfg.num_params_model),
             "num_frames": int(s.cfg.num_frames),
             "model_mask": np.asarray(s.model_mask)[used].astype(
                 int).tolist()}
    bits = write_bitstream(a.out + ".smoe", qp, s.cfg, extra=extra)
    rec = np.asarray(decode_bitstream(a.out + ".smoe"))
    stride = 4
    out["stride"] = stride
    out["sample"] = np.uint8(np.round(rec[::stride, ::stride] * 255))
    out["psnr_db"] = psnr_from_mse(
        float(np.mean((rec - vid) ** 2)) * 2 ** 16, 8)
    print(f"{a.out}.smoe: {bits} bits, {int(used.sum())} kernels, "
          f"{int(np.asarray(s.model_mask)[used].sum())} on the motion "
          f"plane; decode PSNR {out['psnr_db']:.4f} dB")
    np.savez_compressed(a.out + "_ref.npz", **out)
    print(f"wrote {a.out}_ref.npz "
          f"({os.path.getsize(a.out + '_ref.npz')} bytes) and {a.out}.smoe "
          f"({os.path.getsize(a.out + '.smoe')} bytes)")


if __name__ == "__main__":
    main()
