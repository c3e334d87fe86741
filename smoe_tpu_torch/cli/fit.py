"""Training CLI of the PyTorch port (from smoe_tpu/cli/fit.py; the
reference's smoe_test.py, argparse surface smoe_test.py:260-356).

Usage:
    python -m smoe_tpu_torch.cli.fit -i image.png -r results/ \
        [-n 10000 -k 12 ...] [--device cuda]

The JAX CLI's image, video and light-field paths: the fit (K1 forward and
K2 backward on the card), the least-squares expert init and refresh
(-lsinit, -lsri), the incremental kernel loop (-is), the SSIM loss (-ssim),
QAT modes 1-3 (-qm), the SV residual (-tvs, -svg, -svreg, -msv),
error-proportional subsampling (-sp < 100), resume (-c, -orfc, -hpc,
-cis); for a video (an .npz bundle of frames and per-frame affines) the
motion-compensated dual-model fit and the per-time-slab reseed loop (-ri);
for a light field (a .mat file) the corner-view mask, weighted by -lfcw;
and the outputs: metrics.jsonl, params/ and reconstructions/ (a PNG, .yuv
or .mat) per validation, checkpoints/ every 100 iterations,
params_best.pkl / params_last.pkl and, with -qm != 0, model_last.smoe and
model_best.smoe (the global best), which smoe_tpu_torch.cli.reconstruct
and smoe_tpu_torch.cli.decode read.  With `--device cuda` (the default)
and no GPU present it fails rather than carry on on the CPU.  The input is
a PNG, an .npz video bundle (cv2's containers need OpenCV's decoder:
convert them to .npz) or a .mat light field (a v7.3 file needs h5py).

--coordinator_address host:port --num_processes N --process_id R (or
torchrun's environment) join a torch.distributed world, NCCL on the card
and gloo with --device cpu.  As in JAX the CLI builds no mesh: every
process runs the whole fit and rank 0 alone writes the results.

Not ported, raising NotImplementedError with their ROADMAP.md Queue 1
item: the loss and image plots and -lsrs (7).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil

import numpy as np


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _nonneg_int(v):
    iv = int(v)
    if iv < 0:
        raise argparse.ArgumentTypeError(
            "ls_refresh_iter must be >= 0 (0 disables)")
    return iv


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags (cli/fit.py:27-201), with the same names and
    defaults, and --device."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-i", "--image_path", type=str, required=True)
    p.add_argument("-r", "--results_path", type=str, required=True)
    p.add_argument("-n", "--iterations", type=int, default=10000)
    p.add_argument("-ni", "--iterations_inc", type=int, default=1000)
    p.add_argument("-na", "--iterations_all", type=int, default=1000)
    p.add_argument("-is", "--inc_steps", type=int, default=0)
    p.add_argument("-tr", "--threshold_rel", type=float, default=0.2)
    p.add_argument("-v", "--validation_iterations", type=int, default=100)
    p.add_argument("-k", "--kernels_per_dim", type=int, default=[12],
                   nargs="+")
    p.add_argument("-p", "--params_file", type=str, default=None)
    p.add_argument("-reg", "--l1reg", type=float, default=0)
    p.add_argument("-lr", "--base_lr", type=float, default=1e-3)
    p.add_argument("-b", "--batches", type=int, default=1)
    p.add_argument("-bz", "--batch_size", type=int, default=None, nargs="+")
    p.add_argument("-c", "--checkpoint_path", type=str, default=None)
    p.add_argument("-d", "--lr_div", type=float, default=100)
    p.add_argument("-m", "--lr_mult", type=float, default=1000)
    p.add_argument("-msv", "--lr_mult_sv", type=float, default=1)
    p.add_argument("-dp", "--disable_train_pis", type=str2bool, default=False)
    p.add_argument("-dg", "--disable_train_gammas", type=str2bool,
                   default=False)
    p.add_argument("-dm", "--disable_train_musx", type=str2bool,
                   default=False)
    p.add_argument("-udc", "--use_diff_center", type=str2bool, default=False)
    p.add_argument("-ra", "--radial_as", type=str2bool, default=False)
    p.add_argument("-ud", "--use_determinant", type=str2bool, default=True)
    p.add_argument("-np", "--normalize_pis", type=str2bool, default=True)
    p.add_argument("-qm", "--quantization_mode", type=int, default=0)
    p.add_argument("-bd", "--bit_depths", type=int, nargs="+",
                   default=[20, 18, 6, 10, 10])
    p.add_argument("-lean", "--lean_bits", type=str2bool, default=False,
                   help="override -bd with the lean allocation "
                        "A10/mu12/nu8/pi10/g8")
    p.add_argument("-ulean", "--ultra_lean_bits", type=str2bool,
                   default=False,
                   help="override -bd with the ultra-lean allocation "
                        "A8/mu10/nu8/pi10/g6; takes precedence over -lean")
    p.add_argument("-lslean", "--ls_lean_bits", type=str2bool,
                   default=False,
                   help="override -bd with the LS-fit knee "
                        "A8/mu10/nu10/pi10/g8; takes precedence over "
                        "-lean/-ulean")
    p.add_argument("-qp", "--quantize_pis", type=str2bool, default=True)
    p.add_argument("-lb", "--lower_bounds", type=float, nargs="+",
                   default=[-2500, -0.3, -5, 0, -32])
    p.add_argument("-ub", "--upper_bounds", type=float, nargs="+",
                   default=[2500, 1.3, 5, 2, 32])
    p.add_argument("-yuv", "--use_yuv", type=str2bool, default=True)
    p.add_argument("-oyg", "--only_y_gamma", type=str2bool, default=False)
    p.add_argument("-ssim", "--ssim_opt", type=str2bool, default=False)
    p.add_argument("-sp", "--sampling_percentage", type=int, default=100)
    p.add_argument("-ukl", "--update_kernel_list_iterations", type=int,
                   default=None)
    p.add_argument("-ovl", "--overlap_of_batches", type=int, default=0)
    p.add_argument("-pmt", "--probe_maha_threshold", type=float,
                   default=800.0, help="kernel-list probe threshold")
    p.add_argument("-pg", "--probe_grid", type=int, default=3,
                   help="probe points per dim for kernel-list boxes")
    p.add_argument("-iukl", "--in_graph_ukl", type=str2bool, default=False,
                   help="refresh kernel lists every sweep (survivors | "
                        "probe-near) instead of only every -ukl iterations")
    p.add_argument("-nuanchor", "--nu_anchor", type=str2bool, default=False,
                   help="code nu at the decoded kernel center")
    p.add_argument("-ganchor", "--gamma_anchor", type=str2bool,
                   default=False,
                   help="code gamma in the steering-whitened basis")
    p.add_argument("-lfcw", "--lf_corner_weight", type=float, default=0.0,
                   help="4D light fields: corner-view loss weight")
    p.add_argument("--no_canonicalize", action="store_true",
                   help="preserve trained steering signs in the codec")
    p.add_argument("-svreg", "--svreg", type=float, default=0)
    p.add_argument("-hpc", "--hpc_mode", type=str2bool, default=False)
    p.add_argument("-cis", "--current_inc_step", type=int, default=0)
    p.add_argument("-orfc", "--only_rec_from_checkpoint", type=str2bool,
                   default=False)
    p.add_argument("-kcn", "--kernel_count_norm_l1", type=str2bool,
                   default=False)
    p.add_argument("-tvs", "--train_svs", type=str2bool, default=False)
    p.add_argument("-svg", "--sv_shared_grid", type=str2bool, default=False)
    p.add_argument("-tt", "--train_trafo", type=str2bool, default=False)
    p.add_argument("-npm", "--num_params_model", type=int, default=6)
    p.add_argument("-tiv", "--train_inverse_cov", type=str2bool,
                   default=False)
    p.add_argument("-if", "--init_flag", type=float, default=1)
    p.add_argument("-ri", "--reseed_iterations", type=int, default=1000,
                   help="retrain iterations per video time-slab reseed")
    p.add_argument("-lsinit", "--ls_init", type=str, default="",
                   choices=["", "auto", "kernel", "coupled"],
                   help="closed-form least-squares expert init under the "
                        "initial gating before training (fit/lsinit.py)")
    p.add_argument("-lsri", "--ls_refresh_iter", type=_nonneg_int, default=0,
                   help="re-solve the experts in closed form every N "
                        "training iterations (line-searched)")
    p.add_argument("-lsrip", "--ls_refresh_phases", type=str, default="all",
                   choices=["all", "initial"],
                   help="which train phases run the -lsri refresh: every "
                        "phase, or the first fit only")
    p.add_argument("-lsrs", "--ls_refresh_stop", type=_nonneg_int, default=0,
                   help="not ported: a measured dead end")
    p.add_argument("-mask", "--loss_mask_path", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the fit into DIR")
    # multi-process runtime (cli/fit.py:194-200): the world of
    # torch.distributed, NCCL on the card and gloo on the CPU
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0; joins a torch.distributed "
                        "world (parallel/multihost.py)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to fit on (default cuda)")
    return p


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to smoe_tpu_torch yet "
                              f"(ROADMAP.md Queue 1 item {item})")


def _refuse_unported(args) -> None:
    if args.ls_refresh_stop:
        _not_ported("-lsrs (ls_refresh_stop, a measured dead end)", 7)


def main(args=None):
    args = build_parser().parse_args(args)
    if len(args.bit_depths) != 5:
        raise ValueError("Number of bit depths must be five!")
    if args.lean_bits:
        args.bit_depths = [10, 12, 8, 10, 8]     # A, musX, nu_e, pis, gamma_e
    if args.ultra_lean_bits:
        args.bit_depths = [8, 10, 8, 10, 6]
    if args.ls_lean_bits:
        args.bit_depths = [8, 10, 10, 10, 8]
    if args.num_params_model not in (2, 4, 6, 8):
        raise ValueError(f"num_params_model == {args.num_params_model} "
                         "is not a valid motion parameter model")
    if args.ssim_opt:
        args.sampling_percentage = 100
    if not (0 < args.sampling_percentage <= 100):
        raise ValueError("Sampling percentage must be in (0, 100]")
    _refuse_unported(args)
    quantize_pis = args.quantize_pis or args.quantization_mode >= 2

    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to fit on the CPU)")
    from smoe_tpu_torch.parallel import multihost
    # as in JAX the CLI builds no mesh: every process runs the whole fit,
    # and rank 0 alone writes the results
    multihost.initialize(args.coordinator_address, args.num_processes,
                         args.process_id, device=args.device)

    from smoe_tpu_torch.codec.container import load_params, save_model
    from smoe_tpu_torch.config import OptConfig
    from smoe_tpu_torch.diag.log import JsonlLogger, ModelLogger
    from smoe_tpu_torch.fit.trainer import Smoe
    from smoe_tpu_torch.io.images import read_image, write_image

    orig, precision, affines = read_image(args.image_path, args.use_yuv)
    use_yuv = args.use_yuv and orig.shape[-1] == 3
    init_params_dict = load_params(args.params_file) \
        if args.params_file else None
    loss_mask = None
    if args.loss_mask_path:
        loss_mask = np.load(args.loss_mask_path)["loss_mask"]

    if multihost.primary():
        if os.path.exists(args.results_path):
            shutil.rmtree(args.results_path)
        os.makedirs(args.results_path)

    kpd = args.kernels_per_dim
    if len(kpd) == 1:
        kpd = kpd * (orig.ndim - 1)
    dim = orig.ndim - 1
    if dim >= 3 and not args.in_graph_ukl:
        # at d >= 3 the A learning rate sharpens kernels faster than
        # host-cadence list refreshes heal (cli/fit.py:250-261)
        print("WARNING: video/light-field fit without -iukl 1 — "
              "host-cadence kernel lists measurably degrade DECODED "
              "quality (list-drift pathology, see ROADMAP.md); "
              "-iukl 1 is strongly recommended", flush=True)

    smoe = Smoe(
        orig, kernels_per_dim=kpd, init_params_dict=init_params_dict,
        affines=affines, init_flag=args.init_flag,
        start_batches=args.batches,
        batch_size=tuple(args.batch_size) if args.batch_size else None,
        loss_mask=loss_mask,
        opt_cfg=OptConfig(base_lr=args.base_lr, lr_div=args.lr_div,
                          lr_mult=args.lr_mult, lr_mult_sv=args.lr_mult_sv),
        device=args.device,
        train_pis=not args.disable_train_pis,
        train_gammas=not args.disable_train_gammas,
        train_musx=not args.disable_train_musx,
        use_diff_center=args.use_diff_center, radial_as=args.radial_as,
        use_determinant=args.use_determinant,
        normalize_pis=args.normalize_pis,
        quantization_mode=args.quantization_mode,
        bit_depths=tuple(args.bit_depths), quantize_pis=quantize_pis,
        lower_bounds=tuple(args.lower_bounds),
        upper_bounds=tuple(args.upper_bounds),
        use_yuv=use_yuv, only_y_gamma=args.only_y_gamma and use_yuv,
        ssim_opt=args.ssim_opt, precision=precision,
        add_kernel_slots=args.inc_steps * int(np.prod(kpd)),
        overlap=args.overlap_of_batches,
        kernel_count_as_norm_l1=args.kernel_count_norm_l1,
        train_svs=args.train_svs, sv_shared_grid=args.sv_shared_grid,
        train_trafo=args.train_trafo,
        num_params_model=args.num_params_model,
        train_inverse_cov=args.train_inverse_cov,
        probe_maha_threshold=args.probe_maha_threshold,
        in_graph_ukl=args.in_graph_ukl, probe_grid=args.probe_grid,
        canonicalize_steering=not args.no_canonicalize,
        nu_anchor=args.nu_anchor, gamma_anchor=args.gamma_anchor,
        lf_corner_weight=args.lf_corner_weight)
    smoe.set_optimizer()

    if args.checkpoint_path:
        smoe.restore(args.checkpoint_path)
        if args.normalize_pis:
            smoe.re_normalize_pis()
        smoe.update_kernel_list()

    if args.only_rec_from_checkpoint:
        # reconstruction only, from a restored checkpoint
        smoe.run_batched(train=False, update_reconstruction=True)
        if not multihost.primary():
            return smoe
        out = write_image(smoe.get_reconstruction(),
                          os.path.join(args.results_path, "reconstruction"),
                          orig.ndim - 1, yuv=use_yuv,
                          precision=smoe.cfg.precision)
        print(f"wrote {out}")
        return smoe

    # HPC job arrays: resume inc insertion at step N (cli/fit.py:317-326);
    # the checkpoint restores kernel_count, so set the absolute value
    if args.hpc_mode and args.current_inc_step > 0:
        smoe.kernel_count = smoe.cfg.start_pis + \
            (args.current_inc_step - 1) * smoe.num_inc_kernels
        smoe.kernel_lists = torch.ones_like(smoe.kernel_lists)

    if args.ls_init:
        mass = smoe.ls_init_experts(mode=args.ls_init)
        print(f"LS expert init ({args.ls_init}): gated mass {mass:.1f}",
              flush=True)

    # -lsri cadence per phase: the video reseed and inc retrains drop it
    # under -lsrip initial
    lsri_first = args.ls_refresh_iter or None
    lsri_later = lsri_first if args.ls_refresh_phases == "all" else None
    # the writers are no-ops off rank 0, but every rank keeps the same
    # callbacks list, so `bool(callbacks)` (and with it the evals each
    # validation runs) agrees across ranks (cli/fit.py:340-346)
    callbacks = [ModelLogger(path=args.results_path).log,
                 JsonlLogger(os.path.join(args.results_path,
                                          "metrics.jsonl")).log] \
        if multihost.primary() else [lambda smoe: None] * 2

    if args.iterations:
        from smoe_tpu_torch.diag.profile import trace
        prof = trace(args.profile_dir) if args.profile_dir \
            else contextlib.nullcontext()
        with prof:
            smoe.train(args.iterations, val_iter=args.validation_iterations,
                       ukl_iter=args.update_kernel_list_iterations,
                       pis_l1=args.l1reg, sv_l1_sub_l2=args.svreg,
                       sampling_percentage=args.sampling_percentage,
                       use_loss_mask=loss_mask is not None,
                       callbacks=callbacks, ls_refresh_iter=lsri_first)

        # video: per-time-slab kernel reseeding and retrain, the pis
        # learning rate x 10 for the refits (cli/fit.py:384-410, reference
        # smoe_test.py:123-207)
        if dim == 3 and affines is not None:
            smoe.set_optimizer(OptConfig(
                base_lr=args.base_lr, lr_div=args.lr_div / 10,
                lr_mult=args.lr_mult, lr_mult_sv=args.lr_mult_sv))
            for kk in range(kpd[2]):
                try:
                    smoe.reseed_time_slab(kk, rng=kk)
                except ValueError as e:
                    print(f"reseed stopped: {e}")
                    break
                if args.ls_init:
                    # refit all experts under the post-reseed gating (the
                    # reseeded slab's are sample-initialized); the exact
                    # line search cannot regress the blend mse
                    smoe.ls_init_experts(mode=args.ls_init)
                its = args.reseed_iterations * (5 if kk == kpd[2] - 1 else 1)
                # as in the reference, the retrains thread no loss mask
                smoe.train(its, val_iter=args.validation_iterations,
                           ukl_iter=args.update_kernel_list_iterations,
                           pis_l1=args.l1reg, sv_l1_sub_l2=args.svreg,
                           sampling_percentage=args.sampling_percentage,
                           ls_refresh_iter=lsri_later, callbacks=callbacks)

    # incremental kernel loop (reference smoe_test.py:221-245)
    if args.inc_steps and (not args.hpc_mode or args.iterations == 0):
        for i in range(args.inc_steps):
            print(f"[{i}/{args.inc_steps}]")
            smoe.reinit_inc(threshold_rel=args.threshold_rel)
            smoe.apply_inc()
            if args.ls_init:
                smoe.ls_init_experts(mode=args.ls_init)
            smoe.train(args.iterations_inc,
                       val_iter=args.validation_iterations,
                       pis_l1=0, sv_l1_sub_l2=args.svreg,
                       ls_refresh_iter=lsri_later, callbacks=callbacks)
            smoe.train(args.iterations_all,
                       val_iter=args.validation_iterations,
                       pis_l1=args.l1reg, sv_l1_sub_l2=args.svreg,
                       ls_refresh_iter=lsri_later, callbacks=callbacks)
            if args.hpc_mode:
                break

    if multihost.primary():
        _write_results(smoe, args, orig)
    return smoe


def _write_results(smoe, args, orig) -> None:
    """params_best.pkl (the global best across train phases) and
    params_last.pkl; with quantization also model_last.smoe and
    model_best.smoe (cli/fit.py:434-496)."""
    from smoe_tpu_torch.codec.alloc import mask_numpy
    from smoe_tpu_torch.codec.container import save_model
    from smoe_tpu_torch.codec.quantize import quantize_params
    quant = args.quantization_mode != 0
    grid = None if smoe.musX_grid is None else smoe.musX_grid.cpu().numpy()
    mask = mask_numpy(smoe)
    if quant and smoe.qparams is None:
        smoe.qparams = quantize_params(smoe.get_params(), smoe.cfg,
                                       musX_grid=grid)
    for name, params in (("params_best.pkl", smoe.get_global_best_params()),
                         ("params_last.pkl", smoe.get_params())):
        save_model(os.path.join(args.results_path, name), params, smoe.cfg,
                   qparams=smoe.qparams if quant else None,
                   losses=smoe.get_losses(), mses=smoe.get_mses(),
                   num_pis=smoe.get_num_pis(), musX_grid=grid,
                   model_mask=mask)
    if not quant:
        return
    n_pix = int(np.prod(orig.shape[:-1]))
    for name, params, qparams in (
            ("model_last.smoe", smoe.get_params(), smoe.qparams),
            ("model_best.smoe", smoe.get_global_best_params(), None)):
        bits = write_model(os.path.join(args.results_path, name), params,
                           smoe.cfg, orig.shape, qparams=qparams,
                           model_mask=mask)
        print(f"{name}: {bits} bits, bpp {bits / n_pix:.4f}")


def video_extra(params, cfg, qparams, model_mask) -> dict:
    """The video fields of a .smoe header (cli/fit.py:473-486): the motion
    rows h11..h32 of the `params` snapshot (get_params applies their 8-bit
    fake-quant), the motion model and frame count, and the dual model's
    mask over the used kernels.  Empty for a model without motion."""
    if params is None or "h11" not in params:
        return {}
    extra = {"motion": np.stack([np.asarray(params[r], np.float32) for r in
                                 ("h11", "h12", "h13", "h21", "h22", "h23",
                                  "h31", "h32")]).tolist(),
             "num_params_model": int(cfg.num_params_model),
             "num_frames": int(cfg.num_frames)}
    if model_mask is not None:
        used = np.asarray(qparams["used_kernels"], bool)
        extra["model_mask"] = np.asarray(model_mask)[used].astype(
            int).tolist()
    return extra


def write_model(path: str, params, cfg, image_shape, qparams=None,
                model_mask=None) -> int:
    """The .smoe bitstream of `params` (a get_params() dict) for an image
    or video of `image_shape` (*spatial, C): `qparams`, or
    quantize_params(params, cfg) without a grid, as the JAX CLI writes
    model_best.smoe; a video model's header carries `video_extra`.  Returns
    the payload bits."""
    from smoe_tpu_torch.codec.bitstream import write_bitstream
    from smoe_tpu_torch.codec.quantize import quantize_params
    if qparams is None:
        qparams = quantize_params(params, cfg)
    extra = {"shape_of_img": list(image_shape[:-1]),
             "dim_of_output": image_shape[-1], "use_yuv": cfg.use_yuv,
             "use_determinant": cfg.use_determinant,
             "train_gammas": cfg.train_gammas}
    extra.update(video_extra(params, cfg, qparams, model_mask))
    return write_bitstream(path, qparams, cfg, extra=extra)


if __name__ == "__main__":
    main()
