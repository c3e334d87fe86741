"""Inpainting workload demo (from scripts/demo_inpaint.py): the loss mask
as hole filling.

Holes are punched into a structured image; the fit sees only the pixels
outside them (loss_mask = 0 inside), and the continuous SMoE model
interpolates across them.  Reports the PSNR over the hole pixels against
the clean image, a number the masked loss never saw.

    python -m smoe_tpu_torch.apps.demo_inpaint [--size 128] [--iters 600]
        [--k 8] [--cpu | --device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from smoe_tpu_torch.apps import add_device_arg, device_of


def build(size):
    """(image, mask): build_image(size) and six seeded rectangular holes
    (mask 0 inside, 1 on the trusted pixels)."""
    from smoe_tpu_torch.apps.content import build_image
    img = build_image(size)
    rng = np.random.default_rng(7)
    mask = np.ones(img.shape[:2], np.float32)
    for _ in range(6):
        h = rng.integers(size // 16, size // 6)
        w = rng.integers(size // 16, size // 6)
        y = rng.integers(0, size - h)
        x = rng.integers(0, size - w)
        mask[y:y + h, x:x + w] = 0.0
    return img, mask


def corrupt(img, mask):
    """The image with its holes set to 0.5: the fit must never look
    there."""
    out = img.copy()
    out[mask == 0.0] = 0.5
    return out


def trainer(corrupted, mask, k: int, device, **cfg):
    """The masked fit's trainer after its LS expert init (the solve weights
    its rows by the mask too), ready for its first sweep."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(corrupted, kernels_per_dim=[k], loss_mask=mask, device=device,
             **cfg)
    s.set_optimizer()
    s.ls_init_experts()
    return s


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--k", type=int, default=8)
    add_device_arg(ap, cpu_flag=True)
    args = ap.parse_args(argv)
    device = device_of(args.device, args.cpu)

    img, mask = build(args.size)
    holes = mask == 0.0
    corrupted = corrupt(img, mask)

    def psnr_on(rec, sel):
        mse = float(np.mean((rec[sel] - img[sel]) ** 2)) * 255.0 ** 2
        return 10 * np.log10(255.0 ** 2 / mse)

    s = trainer(corrupted, mask, args.k, device)
    s.train(args.iters, val_iter=max(args.iters // 5, 1), ukl_iter=100,
            use_loss_mask=True)
    s.run_batched(train=False, update_reconstruction=True)
    rec = np.asarray(s.get_reconstruction(), np.float32)
    if rec.shape[-1] != img.shape[-1]:
        rec = rec[..., : img.shape[-1]]

    out = {
        "metric": "inpaint_demo",
        "hole_frac": round(float(holes.mean()), 4),
        "psnr_holes_input_db": round(psnr_on(corrupted, holes), 2),
        "psnr_holes_db": round(psnr_on(rec, holes), 2),
        "psnr_trusted_db": round(psnr_on(rec, ~holes), 2),
        "kernels": int(np.asarray(s.get_num_pis()).reshape(-1)[-1]),
        "iters": args.iters,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
