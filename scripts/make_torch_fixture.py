"""Write the serving-decode fixture that ties the PyTorch port to the JAX
package: a `.smoe` of the bench flagship (512^2 RGB, 16x16 kernels, YUV
loss, determinant gating; bench.py:26, 46-54) and the JAX decode's
reference values.

    JAX_PLATFORMS=cpu python scripts/make_torch_fixture.py [-n 100]

Outputs (committed, a few KB):
    tests/data/bench512_k256.smoe      the quantized fit, as cli/fit writes it
    tests/data/bench512_k256_ref.npz   psnr_db: PSNR of the JAX decode to
                                       bench.build_image(512) (repo
                                       convention, core/losses.psnr_from_mse);
                                       sample: uint8 rec[::8, ::8] (64x64x3);
                                       stride: 8

The card has no JAX, so `chip_smoke.py` checks the port's decode against
these recorded values instead of against a live JAX decode.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE = 8


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--iters", type=int, default=100)
    p.add_argument("-o", "--out_dir", default=os.path.join(ROOT, "tests",
                                                           "data"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import BENCH_K, build_image
    from smoe_tpu import Smoe
    from smoe_tpu.codec.bitstream import write_bitstream
    from smoe_tpu.codec.quantize import quantize_params
    from smoe_tpu.codec.serve import decode_bitstream
    from smoe_tpu.core.losses import psnr_from_mse

    img = build_image(512)
    s = Smoe(img, kernels_per_dim=[BENCH_K], use_yuv=True,
             use_determinant=True)
    s.set_optimizer()
    t0 = time.time()
    s.run_batched_chunk(a.iters)
    print(f"fit: {a.iters} iterations in {time.time() - t0:.1f} s")

    qp = quantize_params(s.get_params(), s.cfg)
    os.makedirs(a.out_dir, exist_ok=True)
    path = os.path.join(a.out_dir, "bench512_k256.smoe")
    bits = write_bitstream(path, qp, s.cfg, extra={
        "shape_of_img": list(img.shape[:2]),
        "dim_of_output": img.shape[-1],
        "use_yuv": s.cfg.use_yuv,
        "use_determinant": s.cfg.use_determinant,
        "train_gammas": s.cfg.train_gammas})

    rec = np.asarray(decode_bitstream(path))
    p = s.cfg.precision
    psnr = psnr_from_mse(float(np.mean((rec - img) ** 2)) * (2 ** p) ** 2, p)
    sample = np.uint8(np.round(rec[::STRIDE, ::STRIDE] * 255))
    np.savez(os.path.join(a.out_dir, "bench512_k256_ref.npz"),
             psnr_db=np.float64(psnr), sample=sample, stride=STRIDE)
    print(f"wrote {path}: {bits} payload bits, {os.path.getsize(path)} "
          f"bytes; JAX decode PSNR {psnr:.4f} dB")


if __name__ == "__main__":
    main()
