"""Denoising workload demo (from scripts/demo_denoise.py): fit SMoE on a
noisy image and measure the denoised PSNR against the clean original (the
reference's DenoisePlotter workload, plotter.py:280-351).

The kernel budget is the denoiser: K kernels can only represent smooth
piecewise-steered structure, so i.i.d. noise has nowhere to live.

    python -m smoe_tpu_torch.apps.demo_denoise [--size 128] [--k 8]
        [--n 600] [--val 100] [--sigma 0.05] [--plot-dir DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of


def images(size: int, sigma: float):
    """(clean, noisy): build_image(size) and it plus seeded Gaussian noise
    of std sigma, clipped to [0, 1]."""
    from smoe_tpu_torch.apps.content import build_image
    clean = build_image(size)
    rng = np.random.default_rng(1)
    noisy = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1
                    ).astype(np.float32)
    return clean, noisy


def trainer(noisy, k: int, device, **cfg):
    """The fit's trainer, ready for its first sweep."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(noisy, kernels_per_dim=[k], use_yuv=True, use_determinant=True,
             device=device, **cfg)
    s.set_optimizer()
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--k", type=int, default=8, help="kernels per dim")
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--val", type=int, default=100)
    ap.add_argument("--sigma", type=float, default=0.05,
                    help="Gaussian noise std in [0,1] units")
    ap.add_argument("--plot-dir", type=str, default=None,
                    help="write DenoisePlotter panels here")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    from smoe_tpu_torch.core.losses import psnr_from_mse
    clean, noisy = images(args.size, args.sigma)
    in_mse = float(np.mean((noisy - clean) ** 2)) * 255 ** 2
    in_psnr = psnr_from_mse(in_mse, 8)

    callbacks = []
    if args.plot_dir:
        from smoe_tpu_torch.diag.plots import DenoisePlotter
        callbacks = [DenoisePlotter(clean, path=args.plot_dir).plot]

    t0 = time.time()
    s = trainer(noisy, args.k, device)
    s.train(args.n, val_iter=args.val, callbacks=callbacks)
    fit_s = time.time() - t0

    # the last iterate first: on a noisy target the best snapshot against
    # the noisy image slightly overfits the noise, so the smoother last
    # iterate can denoise better; both numbers are reported
    s.run_batched(train=False, update_reconstruction=True)
    rec_last = np.asarray(s.get_reconstruction())
    last_mse = float(np.mean((rec_last - clean) ** 2)) * 255 ** 2

    # then the best-validation snapshot (what model_best ships)
    s.set_params(s.get_global_best_params())
    s.run_batched(train=False, update_reconstruction=True)
    rec = np.asarray(s.get_reconstruction())
    out_mse = float(np.mean((rec - clean) ** 2)) * 255 ** 2
    out_psnr = psnr_from_mse(out_mse, 8)
    fit_mse = float(np.mean((rec - np.asarray(s.image)) ** 2)) * 255 ** 2

    out = {
        "metric": "denoise_psnr_to_clean_db",
        "value": round(out_psnr, 2),
        "unit": "dB",
        "noisy_input_psnr_db": round(in_psnr, 2),
        "gain_db": round(out_psnr - in_psnr, 2),
        "fit_psnr_to_noisy_db": round(psnr_from_mse(fit_mse, 8), 2),
        "last_iterate_psnr_to_clean_db": round(psnr_from_mse(last_mse, 8),
                                               2),
        "sigma": args.sigma, "kernels": args.k ** 2,
        "size": args.size, "iters": args.n,
        "fit_wallclock_s": round(fit_s, 1),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
