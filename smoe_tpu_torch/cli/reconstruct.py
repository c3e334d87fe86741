"""Decode path A with the PyTorch port: rebuild from a params pickle,
optionally quantize -> rescale, reconstruct, write image + qparams pickle
+ model.smoe (from smoe_tpu/cli/reconstruct.py; reference
smoe_reconstruction.py:15-104).

Usage:
    python -m smoe_tpu_torch.cli.reconstruct -i image.png -p params.pkl \
        -r out/ [--device cuda]

With no allocation flag it runs the automatic encode (--auto-bd 0.05
--prune 0).  Its quantized evals run on the trainer's exact plain path
(torch ops); the .smoe it writes decodes through the Hopper kernel K1
(smoe_tpu_torch.cli.decode).  With `--device cuda` (the default) and no
GPU present it fails rather than carry on on the CPU.  The input is a PNG
(d = 2), an .npz video bundle (d = 3; the output is a raw I420 .yuv, and
the .smoe carries the motion rows and the dual model's mask) or a .mat
light field (`LF` (U, V, H, W, C); d = 4: the output is `output.mat` and
a d = 4 .smoe).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def estimate_batches(n_pix, k_cap, user_batches=1, budget_bytes=2 << 30):
    """First-attempt block count for the quantized eval, sized so the
    per-block (Nb, K) gating map + ~6 same-shaped f32 temporaries fit a
    conservative HBM share (the cli/decode.py:98-109 heuristic).  Returns
    max(user choice, next power of two of the estimate) — a user-default
    -b 1 at video scale (8192 kernels x 811k pixels) otherwise OOMs at
    compile time (measured round 5, k=32 rotating clip: 26.6 GB > 17 GB).
    """
    est = max(1, int(np.ceil(n_pix * k_cap * 4 * 6 / budget_bytes)))
    return max(user_batches, 1 << (est - 1).bit_length())


def main(args=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--image_path", type=str, required=True)
    p.add_argument("-r", "--results_path", type=str, default="/tmp")
    p.add_argument("-p", "--params_file", type=str, required=True)
    p.add_argument("-b", "--batches", type=int, default=1)
    p.add_argument("-q", "--quantize", type=lambda v: v.lower() in
                   ("1", "true", "yes"), default=True)
    p.add_argument("-bd", "--bit_depths", type=int, nargs="+",
                   default=None,
                   help="explicit per-group depths [A mu nu pi gamma]; "
                        "when NO allocation flag is given the encode "
                        "defaults to the composed AUTOMATIC encode "
                        "(--auto-bd 0.05 --prune 0), which measured "
                        "better than every hand table on its own fit "
                        "(BASELINE round-4 rows); --ref restores the "
                        "reference's fixed depths")
    p.add_argument("--ref", action="store_true",
                   help="reference-parity encode: fixed depths "
                        "[20, 18, 6, 10, 10] (smoe_test.py:302), no "
                        "automatic allocation/prune search (the "
                        "pre-round-5 default behavior)")
    p.add_argument("-lean", "--lean_bits", type=lambda v: v.lower() in
                   ("1", "true", "yes"), default=False,
                   help="quantize/code with the lean allocation "
                        "A10/mu12/nu8/pi10/g8 (see cli/fit.py -lean)")
    p.add_argument("-ulean", "--ultra_lean_bits", type=lambda v: v.lower()
                   in ("1", "true", "yes"), default=False,
                   help="quantize/code with the ultra-lean allocation "
                        "A8/mu10/nu8/pi10/g6 (the measured per-group "
                        "transparency knee; see cli/fit.py -ulean)")
    p.add_argument("-lslean", "--ls_lean_bits", type=lambda v: v.lower()
                   in ("1", "true", "yes"), default=False,
                   help="quantize/code with the LS-fit knee "
                        "A8/mu10/nu10/pi10/g8 (see cli/fit.py -lslean); "
                        "takes precedence over -lean/-ulean")
    p.add_argument("-nuanchor", "--nu_anchor", type=lambda v: v.lower()
                   in ("1", "true", "yes"), default=False,
                   help="re-code nu at the decoded kernel CENTER (see "
                        "cli/fit.py -nuanchor; decode-exact, old files "
                        "unaffected)")
    p.add_argument("-ganchor", "--gamma_anchor", type=lambda v: v.lower()
                   in ("1", "true", "yes"), default=False,
                   help="re-code gamma in the steering-whitened basis (see "
                        "cli/fit.py -ganchor; decode-exact, old files "
                        "unaffected)")
    p.add_argument("--auto-bd", type=float, default=None, metavar="TOL_DB",
                   help="search the per-group bit allocation for THIS fit "
                        "(codec/alloc.py): greedy descent from a generous "
                        "allocation, accepting reductions while the real "
                        "quantized decode stays within TOL_DB of it.  The "
                        "knee is fit-dependent (round 4: LS fits need "
                        "nu10/g8 where Adam fits are fine at nu8/g6), so "
                        "this replaces hand-picked -lean/-ulean/-lslean "
                        "knees with a measured one.  Overrides -bd")
    p.add_argument("-layers", "--layers", type=int, default=None,
                   help="write an SNR-scalable LAYERED bitstream with N "
                        "importance-ordered kernel tiers — any tier "
                        "prefix decodes to a coarser model "
                        "(cli/decode --layers m)")
    p.add_argument("--prune", type=float, default=None, metavar="TOL_DB",
                   help="RD-prune at encode: sweep importance-ordered "
                        "kernel prefixes through the real quantized decode "
                        "(dual-model video fits sweep a model-split "
                        "ordering too), keep the smallest whose decoded "
                        "PSNR is within TOL_DB of the best candidate "
                        "(0 = never below the best; the full set is always "
                        "a candidate, so quality never drops below "
                        "full-model minus TOL_DB)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to encode on (default cuda)")
    p.add_argument("--prune-bpp", type=float, default=None, metavar="BPP",
                   help="encoder-side rate control: sweep the same "
                        "candidates, entropy-encode each for its REAL "
                        "payload size, and keep the best-PSNR candidate "
                        "whose coded rate fits the bits-per-pixel budget "
                        "(measured on the flat encode; composing with "
                        "--layers adds the ~3%% tier overhead on top)")
    a = p.parse_args(args)
    # round-5 default (VERDICT r4 #6): with no explicit allocation choice,
    # run the composed AUTOMATIC encode — measured per-group depths
    # (--auto-bd 0.05) + measured prune point (--prune 0) beat every
    # hand-tuned table on their own fits (BASELINE round-4 rows), so the
    # best measured encode is what a new user gets.  Any explicit
    # allocation flag (or --ref) opts out.
    explicit_alloc = (a.bit_depths is not None or a.lean_bits
                      or a.ultra_lean_bits or a.ls_lean_bits
                      or a.auto_bd is not None or a.prune is not None
                      or a.prune_bpp is not None or a.ref)
    if a.bit_depths is None:
        a.bit_depths = [20, 18, 6, 10, 10]
    if not explicit_alloc and a.quantize:
        a.auto_bd, a.prune = 0.05, 0.0
        print("automatic encode (default): --auto-bd 0.05 --prune 0 — "
              "measured allocation + prune point; pass --ref for the "
              "reference's fixed depths or -bd/-lean/... for a hand table",
              flush=True)
    if a.lean_bits:
        a.bit_depths = [10, 12, 8, 10, 8]
    if a.ultra_lean_bits:
        a.bit_depths = [8, 10, 8, 10, 6]
    if a.ls_lean_bits:
        a.bit_depths = [8, 10, 10, 10, 8]
    if a.prune is not None and a.prune_bpp is not None:
        p.error("--prune and --prune-bpp are mutually exclusive")
    if (a.prune is not None or a.prune_bpp is not None) and not a.quantize:
        p.error("--prune/--prune-bpp need quantization (-q 1): the sweep "
                "evaluates quantized decodes")

    import torch

    if torch.device(a.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {a.device}: no CUDA device is available "
                         "(pass --device cpu to encode on the CPU)")

    from smoe_tpu_torch.cli.fit import video_extra
    from smoe_tpu_torch.codec.alloc import grid_numpy, mask_numpy
    from smoe_tpu_torch.codec.container import load_model
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.fit.trainer import Smoe
    from smoe_tpu_torch.io.images import read_image, write_image

    cp = load_model(a.params_file)
    params = cp["params"]
    use_yuv = bool(cp.get("use_yuv", True))
    orig, precision, _ = read_image(a.image_path, use_yuv=use_yuv)

    # rebuild with the checkpoint's codec metadata so re-quantization uses
    # the SAME grid as the training fake-quant (bounds, quantize_pis) and
    # video models keep their motion transform (reference loses both:
    # smoe_reconstruction.py:29 rebuilds with defaults)
    cfg_kw = dict(
        use_yuv=use_yuv and orig.shape[-1] == 3,
        use_determinant=bool(cp.get("use_determinant", True)),
        use_diff_center=bool(cp.get("use_diff_center", False)),
        only_y_gamma=bool(cp.get("only_y_gamma", False)),
        radial_as=bool(cp.get("radial_as",
                               np.asarray(params["A_diagonal"]).ndim == 1)),
        quantize_pis=bool(cp.get("quantized_pis", False)),
        precision=precision, bit_depths=tuple(a.bit_depths),
        quantization_mode=int(cp.get("quantization_mode", 0)),
        nu_anchor=a.nu_anchor, gamma_anchor=a.gamma_anchor)
    if cp.get("lower_bounds") is not None:
        cfg_kw["lower_bounds"] = tuple(cp["lower_bounds"])
    if cp.get("upper_bounds") is not None:
        cfg_kw["upper_bounds"] = tuple(cp["upper_bounds"])
    if cp.get("kernels_per_dim"):
        cfg_kw["kernels_per_dim"] = tuple(cp["kernels_per_dim"])
    if "num_params_model" in cp:
        cfg_kw["num_params_model"] = int(cp["num_params_model"])
        cfg_kw["num_frames"] = int(cp.get("num_frames", orig.shape[2]
                                          if orig.ndim == 4 else 0))

    start_b = estimate_batches(int(np.prod(orig.shape[:-1])),
                               int(np.asarray(params["pis"]).shape[0]),
                               a.batches)
    if start_b > a.batches:
        print(f"memory estimate: starting with {start_b} blocks "
              f"({int(np.prod(orig.shape[:-1]))}px x "
              f"{np.asarray(params['pis']).shape[0]} kernels)", flush=True)

    smoe = Smoe(orig, init_params_dict=params, start_batches=start_b,
                musX_grid_init=cp.get("musX_grid"),
                model_mask_init=cp.get("model_mask"), device=a.device,
                **cfg_kw)

    os.makedirs(a.results_path, exist_ok=True)
    if a.quantize:
        if a.auto_bd is not None:
            # per-FIT allocation search (codec/alloc.py): the knee is
            # fit-dependent (Adam vs LS fits, round 4), so measure it on
            # this model through the real quantized decode
            from smoe_tpu_torch.codec.alloc import (START, choose_anchors,
                                                    search_bit_depths)
            _log = lambda m: print(m, flush=True)   # noqa: E731
            smoe.cfg = smoe.cfg.replace(bit_depths=START)
            nu_a, g_a, _ = choose_anchors(smoe, log=_log)
            bd, p_at, p_ref = search_bit_depths(
                smoe, tol_db=float(a.auto_bd), log=_log)
            smoe.cfg = smoe.cfg.replace(bit_depths=bd)
            print(f"auto-bd: {list(bd)} nu_anchor={int(nu_a)} "
                  f"gamma_anchor={int(g_a)} "
                  f"({p_at:.2f} dB vs generous {p_ref:.2f} dB)")
        musX_grid = grid_numpy(smoe)
        smoe.qparams = quantize_params(smoe.get_params(), smoe.cfg,
                                       musX_grid=musX_grid)

        def grid_of(qp):
            return (None if musX_grid is None else
                    musX_grid[np.asarray(qp["used_kernels"])])

        def qeval(qp):
            smoe.qparams = qp
            smoe.rparams = rescaler(qp, smoe.cfg, grid_of(qp))
            return smoe.run_batched(train=False,
                                    update_reconstruction=True,
                                    with_quantized_params=True)

        def build_extra(qp):
            ex = {"shape_of_img": list(orig.shape[:-1]),
                  "dim_of_output": orig.shape[-1],
                  "use_yuv": smoe.cfg.use_yuv,
                  "use_determinant": smoe.cfg.use_determinant,
                  "train_gammas": smoe.cfg.train_gammas}
            # video: ship the (8-bit fake-quantized) per-frame motion rows
            # and the dual-model domain of the used kernels, so the .smoe
            # decodes without the original (cli/reconstruct.py:223-235)
            ex.update(video_extra(smoe.get_params(), smoe.cfg, qp,
                                  mask_numpy(smoe)))
            return ex

        if a.prune is not None or a.prune_bpp is not None:
            from smoe_tpu_torch.codec.prune import prune_search
            if a.prune_bpp is not None:
                n_pix_b = int(np.prod(orig.shape[:-1]))
                smoe.qparams = prune_search(
                    smoe, target_bits=int(a.prune_bpp * n_pix_b),
                    extra_fn=build_extra)
            else:
                smoe.qparams = prune_search(smoe, float(a.prune))
        loss, mse, *_ = qeval(smoe.qparams)
        rec = smoe.get_qreconstruction()
        with open(os.path.join(a.results_path, "qparams.pkl"), "wb") as fd:
            pickle.dump({**smoe.qparams,
                         "shape_of_img": orig.shape[:-1],
                         "dim_of_output": orig.shape[-1],
                         "used_determinants": smoe.cfg.use_determinant},
                        fd)
        # real entropy-coded bitstream + rate (vs the raw-bits proxy)
        from smoe_tpu_torch.codec.bitstream import write_bitstream
        from smoe_tpu_torch.codec.quantize import rate_bits
        bits = write_bitstream(
            os.path.join(a.results_path, "model.smoe"), smoe.qparams,
            smoe.cfg, extra=build_extra(smoe.qparams), layers=a.layers)
        n_pix = int(np.prod(orig.shape[:-1]))
        print(f"rate: {bits} bits coded "
              f"({rate_bits(smoe.qparams, smoe.cfg)} raw proxy), "
              f"bpp {bits / n_pix:.4f}")
    else:
        loss, mse, *_ = smoe.run_batched(train=False,
                                         update_reconstruction=True)
        rec = smoe.get_reconstruction()

    from smoe_tpu_torch.core.losses import psnr_from_mse
    psnr = psnr_from_mse(mse, precision)
    print(f"decode loss {loss:.6f} mse {mse:.2f} psnr {psnr:.2f} dB")
    out = write_image(rec, os.path.join(a.results_path, "output"),
                      smoe.cfg.dim_domain, yuv=smoe.cfg.use_yuv,
                      precision=precision)
    print(f"wrote {out}")
    return rec


if __name__ == "__main__":
    main()
