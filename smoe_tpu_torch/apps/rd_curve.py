"""RD curve (from scripts/rd_curve.py; BASELINE.md's Config-4):
fit -> quantize -> code -> decoded PSNR.

Sweeps the pi-L1 sparsifier over four points to trade kernels for quality,
measuring the real entropy-coded rate (codec/bitstream.py) and the decoded
PSNR of the best state at each point.  Prints one JSON line per point and
a summary line.

    python -m smoe_tpu_torch.apps.rd_curve [image.png] [iters] [--dp]
        [--lean | --ulean | --lslean] [--lsinit] [--lsri] [--prune]
        [--ganchor] [--family bench|pink|mosaic|text|hopper|mri|dem]
        [--device cuda|cpu]

--family: a content family (apps/content.py): the synthetic bench, pink,
mosaic and text, or the real photographs hopper (RGB), mri and dem (one
channel), read from apps/sample_data/ with numpy alone.
--lsinit: the kernel-mode LS expert solve before the fit (and nu coded at
the kernel center); --lsri: the same solve again every 100 iterations
(sequential path only).
--prune: RD-prune each point at encode (prune_search at 0 dB): the
smallest gating-mass-ordered kernel prefix matching the best decoded PSNR.
--dp: the four points through `parallel.sharded.fit_many`, one model a
rank over a mesh when a torch.distributed world of at least 4 ranks is up
(torchrun's environment wires one), else fitted one after another here.
--lean / --ulean / --lslean: the lean bit allocations A10/mu12/nu8/pi10/g8,
A8/mu10/nu8/pi10/g6, A8/mu10/nu10/pi10/g8 instead of [20, 18, 6, 10, 10].
--ganchor: code gamma in the steering-whitened basis.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from smoe_tpu_torch.apps import device_of

FLAGS = ("--dp", "--lean", "--ulean", "--lslean", "--lsinit", "--lsri",
         "--prune", "--ganchor")
PIS_L1 = (0.0, 1e-5, 1e-4, 5e-4)
CHUNK = 100


def trainer(img, precision, bit_depths, ls_anchor, ganchor, ls_init,
            device, **cfg):
    """One RD point's trainer, 12 x 12 kernels, ready for its first sweep
    (after the kernel-mode LS solve when ls_init)."""
    from smoe_tpu_torch.fit.trainer import Smoe
    s = Smoe(img, kernels_per_dim=[12], use_yuv=img.shape[-1] == 3,
             precision=precision, bit_depths=bit_depths,
             nu_anchor=ls_anchor, gamma_anchor=ganchor, device=device, **cfg)
    s.set_optimizer()
    if ls_init:
        s.ls_init_experts(mode="kernel")
    return s


def _mesh(device, n_models):
    """A one-dimensional mesh over the torch.distributed world when one of
    at least `n_models` ranks is up (torchrun's environment joins it),
    else None."""
    import torch.distributed as dist
    from smoe_tpu_torch.parallel import multihost
    from smoe_tpu_torch.parallel.sharded import axis_mesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        multihost.initialize(num_processes=world, device=device)
    if dist.is_initialized() and dist.get_world_size() >= n_models:
        return axis_mesh("m", device_type=device)
    return None


def main(argv=None) -> dict:
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import (quantize_params, rate_bits,
                                               rescaler)
    from smoe_tpu_torch.core.losses import psnr_from_mse
    from smoe_tpu_torch.io.images import read_image

    raw = list(sys.argv[1:] if argv is None else argv)
    opts = {"--family": "bench", "--device": "cuda"}
    for name in opts:
        if name in raw:
            i = raw.index(name)
            opts[name] = raw[i + 1]
            raw = raw[:i] + raw[i + 2:]
    family = opts["--family"]
    device = device_of(opts["--device"])
    argv = [a for a in raw if a not in FLAGS]
    use_dp, lean, ulean, lslean, lsinit, lsri, prune, ganchor = (
        f in raw for f in FLAGS)
    bit_depths = ((8, 10, 10, 10, 8) if lslean else
                  (8, 10, 8, 10, 6) if ulean else
                  (10, 12, 8, 10, 8) if lean else (20, 18, 6, 10, 10))
    if argv and not argv[0].isdigit():
        img, precision, _ = read_image(argv[0])
        iters = int(argv[1]) if len(argv) > 1 else 1000
    else:
        from smoe_tpu_torch.apps.content import build_family
        img = build_family(family, 256)
        precision = 8
        iters = int(argv[0]) if argv else 1000

    n_pix = int(np.prod(img.shape[:-1]))
    quiet = False

    def measure(s, pis_l1, params=None):
        """Quantize -> entropy-code -> decoded PSNR of s's params."""
        s.qparams = quantize_params(params if params is not None
                                    else s.get_params(), s.cfg)
        if prune:
            from smoe_tpu_torch.codec.prune import prune_search
            s.qparams = prune_search(s, 0.0)
        s.rparams = rescaler(s.qparams, s.cfg)
        _, qmse, npi, _ = s.run_batched(train=False,
                                        update_reconstruction=True,
                                        with_quantized_params=True)
        qpsnr = psnr_from_mse(qmse, precision)
        with tempfile.TemporaryDirectory() as tmp:
            bits = write_bitstream(os.path.join(tmp, "point.smoe"),
                                   s.qparams, s.cfg)
        pt = {"pis_l1": pis_l1, "active_kernels": int(npi),
              "bpp": round(bits / n_pix, 4),
              "bpp_raw_proxy": round(rate_bits(s.qparams, s.cfg) / n_pix, 4),
              "qpsnr_db": round(float(qpsnr), 2)}
        if not quiet:
            print(json.dumps(pt), flush=True)
        return pt

    points = []
    if use_dp:
        from smoe_tpu_torch.fit.trainer import PARAM_FIELDS
        from smoe_tpu_torch.parallel.sharded import fit_many
        mesh = _mesh(device, len(PIS_L1))
        quiet = mesh is not None and mesh.get_rank() != 0
        s = trainer(img, precision, bit_depths, lsinit, ganchor, False,
                    device)
        imgs = np.repeat(img[None], len(PIS_L1), axis=0)
        batched, _ = fit_many(imgs, s.cfg, steps=iters, mesh=mesh,
                              pis_l1=np.asarray(PIS_L1, np.float32),
                              refresh_every=CHUNK, ls_init=lsinit,
                              device=device)
        for i, pis_l1 in enumerate(PIS_L1):
            s.set_params({f: getattr(batched, f)[i] for f in PARAM_FIELDS})
            points.append(measure(s, pis_l1))
    else:
        for pis_l1 in PIS_L1:
            s = trainer(img, precision, bit_depths, lsinit or lsri, ganchor,
                        lsinit or lsri, device)
            done = 0
            best_loss, best_params = np.inf, None
            while done < iters:           # all iters, the remainder too
                n = min(CHUNK, iters - done)
                loss, _, _, _ = s.run_batched_chunk(n, pis_l1=pis_l1)
                if float(loss[-1]) < best_loss:   # code the best state, as
                    best_loss = float(loss[-1])   # the CLI does
                    best_params = s.get_params()  # (params_best)
                s.update_kernel_list()
                done += n
                if lsri and done < iters:
                    s.ls_init_experts(mode="kernel")
            points.append(measure(s, pis_l1, params=best_params))

    out = {"metric": "rd_curve", "family": family,
           "bit_depths": list(bit_depths), "ganchor": ganchor,
           "points": points}
    if not quiet:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
