"""Serving-side decode throughput (from scripts/bench_decode.py):
dequantized params -> pixels on the card.

Fits and quantizes a model at each size (512^2 x 16^2 kernels and 1024^2 x
24^2, 200 sweeps each), then measures the steady-state decode latency of
the serving decoder (codec/serve.py:make_decoder: one decoder, the
parameters uploaded afresh each call) over 50 frames after a warm-up, and
of a quarter-frame window through `sample_points`; then the CIF dual-model
video (scripts/bench_video.py's clip, 200 sweeps) decoded as one volume
with its motion rows and model mask.  Prints one JSON line per
measurement with the script's keys and the card's name and power limit.

    python -m smoe_tpu_torch.bench.decode [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, content, device_of
from smoe_tpu_torch.bench import common

SIZES = ((512, 16, 200), (1024, 24, 200))
N_FRAMES = 50     # timed calls of each image decoder
N_VIDEO = 20      # and of the video decoder


def quantized(s):
    """s with its quantized and rescaled params (qparams, rparams)."""
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    s.qparams = quantize_params(s.get_params(), s.cfg)
    s.rparams = rescaler(s.qparams, s.cfg)
    return s


def decoder_args(s, d, c):
    from smoe_tpu_torch.codec.serve import pad_decoded_params
    k = int(np.asarray(s.rparams["pis"]).shape[0])
    padded = pad_decoded_params(s.rparams, k, d, c)
    return k, (padded["A"], padded["musX"], padded["nu_e"],
               padded["gamma_e"], padded["pis"])


def frames_ms(dec, args, n, device) -> float:
    """Mean ms a call of n calls, the last one waited for."""
    t0 = common.clock(device)
    for _ in range(n):
        dec(*args)
    return (common.clock(device) - t0) / n * 1000


def emit(out: dict, device) -> dict:
    """Print `out` with the card's fields as one JSON line; returns it."""
    out.update(common.card_fields(device))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    from smoe_tpu_torch.codec.serve import make_decoder
    from smoe_tpu_torch.fit.trainer import Smoe

    lines = []
    for size, kpd, iters in SIZES:
        img = content.build_image(size)
        s = Smoe(img, kernels_per_dim=[kpd], use_yuv=True,
                 use_determinant=True, device=device)
        s.set_optimizer()
        s.run_batched_chunk(iters)
        quantized(s)

        d, c = s.cfg.dim_domain, img.shape[-1]
        k, dargs = decoder_args(s, d, c)
        dec = make_decoder(img.shape[:d], c, s.cfg, k, device=device)
        rec = dec(*dargs).cpu().numpy()       # warm-up + correctness anchor
        mse = float(np.mean((255 * (rec - img)) ** 2))

        dt = frames_ms(dec, dargs, N_FRAMES, device)
        mp = img.shape[0] * img.shape[1] / 1e6
        lines.append(emit({
            "metric": f"decode_ms_per_frame_{size}",
            "value": round(dt, 3),
            "unit": "ms",
            "megapixels": mp,
            "megapixels_per_s": round(mp / (dt / 1000), 1),
            "kernels": k,
            "psnr_db": round(10 * np.log10(255 ** 2 / mse), 2)}, device))

        # a quarter-frame window: the point of window serving
        q = size // 2
        sp = (np.linspace(0, (q - 1) / (size - 1), q, dtype=np.float32),
              np.linspace(0, (q - 1) / (size - 1), q, dtype=np.float32))
        dec_roi = make_decoder(None, c, s.cfg, k, sample_points=sp,
                               device=device)
        dec_roi(*dargs)
        dt_roi = frames_ms(dec_roi, dargs, N_FRAMES, device)
        lines.append(emit({"metric": f"decode_roi_quarter_ms_{size}",
                           "value": round(dt_roi, 3), "unit": "ms",
                           "full_frame_ms": round(dt, 3)}, device))
        del s, dec, dec_roi

    lines.append(video_decode(device))
    return lines


def video_decode(device) -> dict:
    """The motion-compensated dual-model video through the serving decoder:
    the whole 8-frame volume in one call (motion transform and dual-domain
    gating included)."""
    from smoe_tpu_torch.codec.serve import make_decoder
    from smoe_tpu_torch.core.quant import apply_qat
    from smoe_tpu_torch.fit.trainer import Smoe

    vid, affines = content.build_video()
    s = Smoe(vid, kernels_per_dim=[12, 12, 4], affines=affines,
             init_flag=1, use_yuv=True, use_determinant=True, device=device)
    s.set_optimizer()
    s.run_batched_chunk(200)
    quantized(s)

    d, c = s.cfg.dim_domain, vid.shape[-1]
    k, dargs = decoder_args(s, d, c)
    used = np.asarray(s.qparams["used_kernels"], bool)
    motion = apply_qat(s.params, s.cfg).motion.detach().cpu().numpy()
    dec = make_decoder(vid.shape[:d], c, s.cfg, k, motion=motion,
                       model_mask=s.model_mask.cpu().numpy()[used],
                       device=device)
    dec(*dargs)
    common.sync(device)
    dt = frames_ms(dec, dargs, N_VIDEO, device)
    t_frames = vid.shape[2]
    mp = vid.shape[0] * vid.shape[1] * t_frames / 1e6
    return emit({"metric": "decode_ms_per_cif_video",
                 "value": round(dt, 3),
                 "unit": "ms",
                 "frames": t_frames,
                 "ms_per_frame": round(dt / t_frames, 3),
                 "megapixels_per_s": round(mp / (dt / 1000), 1),
                 "kernels": k}, device)


if __name__ == "__main__":
    main()
