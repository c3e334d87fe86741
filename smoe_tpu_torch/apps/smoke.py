"""Quick end-to-end smoke run (from scripts/smoke.py): fit a 32x32 toy
image for 100 sweeps, print the PSNR before and after.

    python -m smoe_tpu_torch.apps.smoke [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of


def toy_image() -> np.ndarray:
    y, x = np.mgrid[0:32, 0:32] / 31.0
    return (0.5 + 0.25 * np.sin(4 * x) * np.cos(3 * y))[..., None].astype(
        np.float32)


def trainer(device, **cfg):
    """The toy's trainer, ready for its first sweep."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(toy_image(), kernels_per_dim=[4], use_yuv=False,
             use_determinant=True, device=device, **cfg)
    s.set_optimizer()
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    device = device_of(ap.parse_args(argv).device)
    s = trainer(device)
    t = time.time()
    loss, mse, npi, nsv = s.run_batched(train=False,
                                        update_reconstruction=True)
    psnr0 = 10 * np.log10(255 ** 2 / mse)
    print(f"eval loss {loss:.6f} mse {mse:.2f} psnr {psnr0:.2f} "
          f"num_pi {npi}  ({time.time() - t:.1f}s)", flush=True)
    t = time.time()
    for i in range(100):
        s.run_batched(train=True)
        if i == 0:
            print(f"first train step {time.time() - t:.1f}s", flush=True)
    loss, mse, *_ = s.run_batched(train=False, update_reconstruction=True)
    psnr = 10 * np.log10(255 ** 2 / mse)
    print(f"after 100 iters: loss {loss:.6f} mse {mse:.2f} "
          f"psnr {psnr:.2f}  ({time.time() - t:.1f}s)", flush=True)
    return {"psnr_initial_db": float(psnr0), "psnr_db": float(psnr)}


if __name__ == "__main__":
    main()
