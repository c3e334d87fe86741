"""Serving decode: `.smoe` bitstream -> pixels, in PyTorch
(from smoe_tpu/codec/serve.py:35-279).

`make_decoder` builds the decode function for one raster; each call
evaluates the model over the pixel grid through `core.model.forward_fused`
(on a CUDA device: the Hopper gate+expert kernel, which never forms the
(pixel, kernel) map, so the whole raster goes in one launch), then clips
and fake-quantizes as the encoder's reconstruction does (serve.py:132-133).
`reference=True` evaluates with the plain torch ops instead, in the JAX
decoder's op order (maha_from_A -> gating -> expert_regression); it
materialises (chunk, K) maps and so runs in pixel chunks.  It is the
parity reference the kernel path is checked against.

A video model (d = 3 with `motion`) transforms the raster by its per-frame
motion rows on every call, exactly as training does (video/motion.py); with
a dual-model `model_mask` the kernel path runs K1 at the 2F = 26 dual-domain
width and the reference path takes the plain maha on the same features.
`mesh=` (a one-dimensional `DeviceMesh`, one process per card) splits the
raster's pixels over the ranks: each evaluates its share with the
parameters replicated and no collective in the math, and the image is
gathered to every rank (serve.py:100-147).  K1 computes every pixel on its
own, so the bits do not depend on the split.

The JAX package jits the decode (serve.py:149).  Here, on the card, a
decoder's first call runs eagerly, its second captures the decode (the
whole chunk loop, K1 on each chunk) as a CUDA graph with the parameters in
buffers that live as long as the decoder, and later calls copy the call's
parameters into those buffers and replay (fit/graph.py:Programs): a bench
that decodes 50 frames, an app that decodes a model again.  A mesh decoder
replays one graph per rank only when its group runs on NCCL; on gloo, in
`eager()`, on the CPU and on the `reference` path it runs eagerly.
`decode_bitstream` decodes once per file, so its decoder never gets to the
second call that would capture: it stays eager, since a capture would
cost more than the one replay saves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smoe_tpu_torch.config import SmoeConfig
from smoe_tpu_torch.core.model import (expert_regression, fake_quant_unit,
                                       forward_fused, gating, maha_from_A)
from smoe_tpu_torch.diag.profile import span
from smoe_tpu_torch.fit.graph import Programs, graphed
from smoe_tpu_torch.parallel.compat import gather_rows
from smoe_tpu_torch.video.motion import transform_coords


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_decoded_params(rp: dict, capacity: int, d: int, c: int) -> dict:
    """Pad reduced (K' active) rescaler output to `capacity` slots
    (dead slots pis=0); serve.py:35-53."""
    out = {}
    k = int(np.asarray(rp["pis"]).shape[0])
    if k > capacity:
        raise ValueError(f"{k} kernels exceed decoder capacity {capacity}")

    def pad(x, shape):
        full = np.zeros((capacity,) + shape, np.float32)
        full[:k] = np.asarray(x, np.float32).reshape((k,) + shape)
        return full

    out["A"] = pad(rp["A"], (d, d))
    out["musX"] = pad(rp["musX"], (d,))
    out["nu_e"] = pad(rp["nu_e"], (c,))
    out["gamma_e"] = pad(rp["gamma_e"], (d, c))
    out["pis"] = pad(rp["pis"], ())
    return out


def make_decoder(img_shape: Tuple[int, ...], channels: int,
                 cfg: SmoeConfig, capacity: int,
                 chunk_pixels: Optional[int] = None,
                 motion: Optional[np.ndarray] = None,
                 model_mask: Optional[np.ndarray] = None,
                 sample_points: Optional[Tuple[np.ndarray, ...]] = None,
                 mesh=None, device="cuda", reference: bool = False):
    """Decoder for one image geometry (serve.py:56-159).

    Returns fn(A (K,d,d), musX (K,d), nu_e (K,C), gamma_e (K,d,C),
    pis (K,)) -> (*img_shape, channels) float32 tensor in [0,1] on
    `device`; the arguments may be numpy arrays or tensors (K <= capacity,
    see `pad_decoded_params`).

    motion: (8, T) per-frame global-motion rows of a d = 3 video model: the
    raster is motion-transformed on every call as in training.
    model_mask: (<= capacity,) bool of a dual-model video (False kernels
    gate on the raw raster), padded with True to the capacity.
    sample_points: per-dim 1D coordinate vectors in [0,1] overriding the
    native raster (gen_domain's linspace(0,1,n)) — the ROI/zoom/SR hook;
    the output raster is their outer product and img_shape is ignored.
    chunk_pixels: pixels per evaluation on the `reference` path and on the
    CPU, whose plain version forms (chunk, K) maps; default keeps each map
    near 8 MB on the CPU and 256 MB on a GPU.  The kernel path on a GPU
    evaluates the whole raster in one launch.
    reference: evaluate with the plain torch ops in the JAX decoder's op
    order instead of the fused op (the parity reference).
    mesh: a one-dimensional DeviceMesh over the decoding processes: the
    (padded) raster splits into equal contiguous shares, one a rank, padded
    to chunks x ranks on the chunked path (serve.py:103-104); every rank
    returns the whole image.

    On the card the decoder replays a captured decode from its second call
    on (the parameters copied into the decoder's own buffers; one graph per
    shape of the parameters; `decode.programs`).
    """
    if mesh is not None and mesh.ndim != 1:
        raise ValueError("the serving decode splits one pixel axis: pass a "
                         "one-dimensional mesh")
    device = torch.device(device)
    d = cfg.dim_domain
    if sample_points is not None:
        if len(sample_points) != d:
            raise ValueError(f"{len(sample_points)} sample axes for d={d}")
        axes = [np.asarray(v, np.float32) for v in sample_points]
        img_shape = tuple(len(v) for v in axes)
    else:
        if len(img_shape) != d:
            raise ValueError(f"img_shape {img_shape} is not {d}-D")
        # gen_domain's per-axis linspace, rounded to fp32 as it rounds them
        axes = [np.linspace(0.0, 1.0, s).astype(np.float32)
                for s in img_shape]
    n = int(np.prod(img_shape))
    # the raster is the outer product of the axes: built on the device, so
    # only the axes cross the bus
    coords = torch.stack(torch.meshgrid(
        *[torch.as_tensor(v, device=device) for v in axes], indexing="ij"),
        dim=-1).reshape(n, d)
    motion_t = None if motion is None or d != 3 else torch.as_tensor(
        np.asarray(motion, np.float32), device=device)
    mm = None
    if model_mask is not None and motion_t is not None:
        m = np.ones((capacity,), bool)
        m[:len(model_mask)] = np.asarray(model_mask, bool)
        mm = torch.as_tensor(m, device=device)
    ranks, rank = (1, 0) if mesh is None else (mesh.size(),
                                               mesh.get_local_rank())
    chunked = reference or device.type == "cpu"
    if not chunked:
        # the whole share in one launch
        chunk_pixels = _round_up(max(-(-n // ranks), 1), 256)
    elif chunk_pixels is None:
        budget = (8 << 20) if device.type == "cpu" else (256 << 20)
        chunk_pixels = _round_up(
            max(1024, min(n, budget // (4 * max(capacity, 1)))), 256)
    # this rank's rows of the raster, padded with zero coords to equal
    # shares; the pad rows are cut after the gather
    n_pad = _round_up(max(n, 1), chunk_pixels * ranks)
    share = n_pad // ranks
    mine = slice(rank * share, (rank + 1) * share)
    if mesh is not None:
        coords = torch.cat([coords, coords.new_zeros((n_pad - n, d))])[mine]

    def chunk_fn(c_blk, A, musX, nu_e, gamma_e, pis, mask):
        c_in, c_raw, mk = c_blk, None, None
        if motion_t is not None:
            c_in = transform_coords(c_blk, motion_t, cfg.num_params_model,
                                    cfg.num_frames)
            if mm is not None:
                c_raw, mk = c_blk, mm[:pis.shape[0]]
        if not reference:
            return forward_fused(A, musX, nu_e, gamma_e, pis, cfg, c_in,
                                 mask, coords_raw=c_raw, model_mask=mk).res
        maha = maha_from_A(A, musX, cfg, c_in, c_raw, mk)
        w_e = gating(maha, pis, torch.diagonal(A, dim1=1, dim2=2), cfg,
                     mask)
        res = expert_regression(w_e, c_in, nu_e, gamma_e, cfg)
        return fake_quant_unit(torch.clamp(res, 0.0, 1.0), cfg.precision)

    def run(A, musX, nu_e, gamma_e, pis):
        mask = pis > 0
        res = torch.cat([chunk_fn(coords[i:i + chunk_pixels], A, musX, nu_e,
                                  gamma_e, pis, mask)
                         for i in range(0, coords.shape[0], chunk_pixels)])
        if mesh is not None:
            res = gather_rows(res, mine, n_pad, mesh.get_group())[:n]
        return res.reshape(tuple(img_shape) + (channels,))

    import torch.distributed as dist
    replayed = not reference and (
        mesh is None or dist.get_backend(mesh.get_group()) == "nccl")
    programs, params = Programs(), {}

    @torch.no_grad()
    def decode(A, musX, nu_e, gamma_e, pis):
        args = tuple(torch.as_tensor(np.asarray(v, np.float32)
                                     if not torch.is_tensor(v) else v,
                                     dtype=torch.float32, device=device)
                     for v in (A, musX, nu_e, gamma_e, pis))
        if not (replayed and graphed(device)):
            return run(*args)
        key = tuple(tuple(a.shape) for a in args)
        bufs = params.get(key)
        if bufs is None:
            bufs = params[key] = tuple(torch.empty_like(a) for a in args)
        for b, a in zip(bufs, args):
            b.copy_(a)
        return programs.run(key, lambda: (run(*bufs),))[0].clone()

    decode.programs = programs
    return decode


def read_model(path: str, layers: Optional[int] = None,
               max_bytes: Optional[int] = None):
    """Entropy-decode and dequantize a `.smoe` file (serve.py:199-235).

    Returns (cfg, params, header): params is the rescaler output as numpy
    arrays (A, musX, nu_e, gamma_e, pis over the K' coded kernels).
    `layers=m` keeps the first m tiers of a layered file; `max_bytes=n`
    picks the largest tier prefix that fits n bytes.  The entropy decode
    runs in the span `smoe.decode.range_decode`, the dequantization in
    `smoe.decode.rescale`.
    """
    from smoe_tpu_torch.codec.bitstream import (_grid_of_used,
                                                layers_for_budget,
                                                read_bitstream)
    from smoe_tpu_torch.codec.quantize import rescaler

    if max_bytes is not None:
        if layers is not None:
            raise ValueError("pass layers= or max_bytes=, not both")
        layers = layers_for_budget(path, max_bytes)
    with span("smoe.decode.range_decode"):
        qp, header = read_bitstream(path, max_layers=layers)
    img_shape = tuple(int(v) for v in np.ravel(header["shape_of_img"]))
    c = int(np.ravel(header.get("dim_of_output", [3]))[0])
    d = len(img_shape)
    cfg = SmoeConfig(
        dim_domain=d, num_channels=c,
        kernels_per_dim=tuple(header["kernels_per_dim"])
        if len(header["kernels_per_dim"]) > 1
        else tuple(header["kernels_per_dim"]) * d,
        precision=int(header.get("precision", 8)),
        use_yuv=bool(header.get("use_yuv", True)) and c == 3,
        use_determinant=bool(header.get("use_determinant", True)),
        use_diff_center=bool(header.get("use_diff_center", False)),
        radial_as=bool(header.get("radial_as", False)),
        train_inverse_cov=bool(header.get("train_inverse_cov", False)),
        num_params_model=int(header.get("num_params_model", 8)),
        num_frames=int(header.get("num_frames",
                                  img_shape[2] if d == 3 else 0)))
    with span("smoe.decode.rescale"):
        rp = rescaler(qp, cfg, musX_grid=_grid_of_used(qp, cfg))
    return cfg, rp, header


def sample_grid(img_shape: Tuple[int, ...], scale: Optional[float] = None,
                roi: Optional[Tuple[Tuple[int, int], ...]] = None,
                frames: Optional[Tuple[int, int]] = None,
                views: Optional[Tuple[Tuple[int, int], ...]] = None):
    """Per-dim sample vectors for a scaled and/or windowed raster
    (serve.py:240-273).  scale and roi act on the spatial dims only; a
    video's frame axis and a light field's view grid keep their native
    sampling, cut to `frames` / `views` when given.  Native pixel i sits at
    i/(N-1), and a window's samples span its first..last native pixel, so
    scale=1 reproduces the crop of the native decode exactly."""
    d = len(img_shape)
    if frames is not None and d != 3:
        raise ValueError("frames= is for video bitstreams (d==3)")
    if views is not None and d != 4:
        raise ValueError("views= is for 4D light-field bitstreams (d==4)")
    spatial = {2: (0, 1), 3: (0, 1), 4: (2, 3)}[d]
    pts = []
    for i, s_dim in enumerate(img_shape):
        if i not in spatial:
            native = np.linspace(0.0, 1.0, s_dim, dtype=np.float32)
            win = frames if d == 3 else views[i] if views is not None \
                else None
            if win is not None:
                lo, hi = win
                if not 0 <= lo < hi <= s_dim:
                    raise ValueError(
                        f"range {(lo, hi)} out of [0,{s_dim}] on dim {i}")
                native = native[lo:hi]
            pts.append(native)
            continue
        lo, hi = roi[spatial.index(i)] if roi is not None else (0, s_dim)
        if not 0 <= lo < hi <= s_dim:
            raise ValueError(f"roi {(lo, hi)} out of [0,{s_dim}]")
        npts = max(int(round((hi - lo) * (scale or 1.0))), 1)
        pts.append(np.linspace(lo / (s_dim - 1), (hi - 1) / (s_dim - 1),
                               npts, dtype=np.float32))
    return pts


def decode_bitstream(path: str, chunk_pixels: Optional[int] = None,
                     return_header: bool = False,
                     scale: Optional[float] = None,
                     out_shape: Optional[Tuple[int, ...]] = None,
                     roi: Optional[Tuple[Tuple[int, int], ...]] = None,
                     frames: Optional[Tuple[int, int]] = None,
                     views: Optional[Tuple[Tuple[int, int], ...]] = None,
                     layers: Optional[int] = None,
                     max_bytes: Optional[int] = None,
                     mesh=None, device="cuda", reference: bool = False):
    """One-call serving decode: .smoe file -> image (numpy), on `device`
    (serve.py:162-279).

    The model is a continuous function on [0,1]^d: `scale=2` renders the
    spatial dims at 2x, `out_shape` names the output raster, and
    `roi=((y0,y1),(x0,x1))` (native-pixel half-open box) renders only that
    window; roi composes with scale.  `frames=(t0,t1)` (video) and
    `views=((u0,u1),(v0,v1))` (4D light field) decode a frame or view
    range.  `layers=m` decodes the first m tiers of a layered bitstream;
    `max_bytes=n` the largest prefix fitting n bytes.  A video file's
    `motion` rows and dual-model `model_mask` come from its header; a frame
    range keeps the native t of its frames, so each pixel still finds its
    own frame's motion.  `mesh=` splits the pixels over the processes of
    a one-dimensional DeviceMesh (see `make_decoder`); every rank returns
    the whole image.  The call is the span `smoe.decode`; the host's wait
    for the decode and the copy of its image is `smoe.decode.to_host`
    (`to_host`: on the card, into page-locked memory; on the `reference`
    path, pageable).
    """
    with span("smoe.decode"):
        cfg, rp, header = read_model(path, layers=layers, max_bytes=max_bytes)
        motion = header.get("motion")
        if motion is not None:
            motion = np.asarray(motion, np.float32)
        model_mask = header.get("model_mask")
        if model_mask is not None:
            model_mask = np.asarray(model_mask, bool)
        img_shape = tuple(int(v) for v in np.ravel(header["shape_of_img"]))
        c, d = cfg.num_channels, cfg.dim_domain
        k = int(np.asarray(rp["pis"]).shape[0])
        padded = pad_decoded_params(rp, max(k, 1), d, c)
        sample_points = None
        if out_shape is None and (scale is not None or roi is not None
                                  or frames is not None or views is not None):
            sample_points = sample_grid(img_shape, scale, roi, frames, views)
        dec = make_decoder(out_shape or img_shape, c, cfg, max(k, 1),
                           chunk_pixels, motion=motion, model_mask=model_mask,
                           sample_points=sample_points, mesh=mesh,
                           device=device, reference=reference)
        rec = dec(padded["A"], padded["musX"], padded["nu_e"],
                  padded["gamma_e"], padded["pis"])
        with span("smoe.decode.to_host"):
            rec = rec.cpu().numpy() if reference else to_host(rec)
        return (rec, header) if return_header else rec


def to_host(rec: torch.Tensor) -> np.ndarray:
    """`rec` as a numpy array in host memory of its own.

    A tensor on the card waits for its stream (`smoe.decode.wait`), then
    copies into a fresh page-locked tensor (`smoe.decode.copy_pinned`):
    the caching host allocator hands back a freed block of the same size
    with no new registration, where a pageable copy of a 4K image goes
    through a staging buffer and faults in every page of new memory.  A
    held result keeps its block; none is shared between calls.  Where the
    page-locked allocation fails, the copy is pageable
    (`smoe.decode.copy_pageable`).  A CPU tensor is returned as it is.
    """
    if rec.device.type != "cuda":
        return rec.cpu().numpy()
    stream = torch.cuda.current_stream(rec.device)
    with span("smoe.decode.wait"):
        stream.synchronize()
    try:
        host = torch.empty(rec.shape, dtype=rec.dtype, pin_memory=True)
    except RuntimeError:
        with span("smoe.decode.copy_pageable"):
            return rec.cpu().numpy()
    with span("smoe.decode.copy_pinned"):
        host.copy_(rec, non_blocking=True)
        stream.synchronize()
    return host.numpy()
