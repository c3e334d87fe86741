"""Record the JAX package's first 20 training sweeps on the bench flagship
(512^2 RGB, 16x16 kernels, YUV loss, determinant gating, one block;
bench.py:26, 46-54) for the PyTorch port's trainer to be held against.

    JAX_PLATFORMS=cpu python scripts/make_torch_train_fixture.py [-n 20]

Output (committed, under 1 KB):
    tests/data/bench512_train20_ref.npz   loss, mse, num_pi: the per-sweep
                                          metrics of run_batched_chunk(n)
                                          from the default init (each
                                          describes the params before its
                                          sweep's update); iters: n

The card has no JAX, so `chip_smoke.py` compares the port's fit on the
card with this recorded trajectory instead of a live JAX fit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--iters", type=int, default=20)
    p.add_argument("-o", "--out", default=os.path.join(
        ROOT, "tests", "data", "bench512_train20_ref.npz"))
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    jax.config.update("jax_platforms", "cpu")

    from bench import BENCH_K, build_image
    from smoe_tpu import Smoe

    img = build_image(512)
    s = Smoe(img, kernels_per_dim=[BENCH_K], use_yuv=True,
             use_determinant=True)
    s.set_optimizer()
    t0 = time.time()
    loss, mse, num_pi, _ = s.run_batched_chunk(a.iters)
    print(f"fit: {a.iters} sweeps in {time.time() - t0:.1f} s; mse "
          f"{float(mse[0]):.4f} -> {float(mse[-1]):.4f}")
    np.savez(a.out, loss=np.asarray(loss, np.float32),
             mse=np.asarray(mse, np.float32),
             num_pi=np.asarray(num_pi, np.int32), iters=a.iters)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()
