"""PyTorch port, the serving slice as a whole: `.smoe` file -> pixels.

The JAX package writes and decodes each bitstream; the port decodes the
same file on the CPU (its fused op's plain version) and must agree to
within 1 LSB of the 8-bit output with at least 99.9 % of values identical:
the two frameworks sum the gating in different orders, which can move a
value across a rounding boundary of the fake quantizer, never further."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import cv2  # noqa: E402

from smoe_tpu.codec.bitstream import write_bitstream  # noqa: E402
from smoe_tpu.codec.quantize import quantize_params  # noqa: E402
from smoe_tpu.codec.serve import decode_bitstream as j_decode  # noqa: E402
from smoe_tpu.config import SmoeConfig  # noqa: E402
from smoe_tpu.core.init import init_params  # noqa: E402
from smoe_tpu.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.codec.serve import decode_bitstream  # noqa: E402
from smoe_tpu_torch.core.losses import psnr_from_mse  # noqa: E402
from smoe_tpu_torch.io import images as timages  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "bench512_k256.smoe")
FIXTURE_REF = os.path.join(ROOT, "tests", "data", "bench512_k256_ref.npz")


def _u8(x):
    return np.uint8(np.round(np.asarray(x) * 255)).astype(np.int32)


def assert_within_lsb(got, want, min_identical=0.999):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(_u8(got) - _u8(want))
    assert diff.max() <= 1, f"max {diff.max()} LSB"
    assert np.mean(diff == 0) >= min_identical, np.mean(diff == 0)


def _extra(shape, c, cfg):
    return {"shape_of_img": list(shape), "dim_of_output": [c],
            "use_yuv": bool(cfg.use_yuv),
            "use_determinant": bool(cfg.use_determinant)}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """As tests/test_serve.py's `fitted`: a 32x32 RGB fit, quantized and
    written by the JAX package flat and with three SNR layers."""
    y, x = np.mgrid[0:32, 0:32] / 31.0
    img = np.stack([.5 + .3 * np.sin(5 * x), .5 + .3 * np.cos(4 * y),
                    .4 + .2 * np.sin(3 * (x + y))], -1).astype(np.float32)
    s = Smoe(img, kernels_per_dim=[4], quantize_pis=True)
    s.set_optimizer()
    s.run_batched_chunk(30)
    qp = quantize_params(s.get_params(), s.cfg)
    out = tmp_path_factory.mktemp("serve")
    flat, layered = str(out / "m.smoe"), str(out / "layered.smoe")
    write_bitstream(flat, qp, s.cfg, extra=_extra(img.shape[:2], 3, s.cfg))
    write_bitstream(layered, qp, s.cfg,
                    extra=_extra(img.shape[:2], 3, s.cfg), layers=3)
    return {"flat": flat, "layered": layered}


DECODES = {
    "native": ("flat", {}),
    "scale2": ("flat", {"scale": 2.0}),
    "out_shape": ("flat", {"out_shape": (63, 63)}),
    "roi": ("flat", {"roi": ((8, 24), (4, 20))}),
    "roi_scale2": ("flat", {"roi": ((8, 24), (4, 20)), "scale": 2.0}),
    "layers1": ("layered", {"layers": 1}),
    "layers2": ("layered", {"layers": 2}),
}


@pytest.mark.parametrize("case", sorted(DECODES))
def test_decode_matches_jax(fitted, case):
    which, kw = DECODES[case]
    path = fitted[which]
    want = j_decode(path, **kw)
    got = decode_bitstream(path, device="cpu", **kw)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert_within_lsb(got, want)
    # the plain path in the JAX decoder's own op order
    assert_within_lsb(decode_bitstream(path, device="cpu", reference=True,
                                       **kw), want)


def test_decode_max_bytes_matches_jax(fitted):
    """A byte budget one short of the layered file decodes a tier prefix."""
    path = fitted["layered"]
    budget = os.path.getsize(path) - 1
    want = j_decode(path, max_bytes=budget)
    assert_within_lsb(decode_bitstream(path, device="cpu",
                                       max_bytes=budget), want)
    assert np.abs(want - j_decode(path)).max() > 0


def test_decode_roi_is_crop_of_native(fitted):
    full = decode_bitstream(fitted["flat"], device="cpu")
    win = decode_bitstream(fitted["flat"], device="cpu",
                           roi=((8, 24), (4, 20)))
    np.testing.assert_allclose(win, full[8:24, 4:20], atol=1e-5)


def _init_model(img, cfg, seed):
    """A quantized model without a fit: the init grid, perturbed."""
    rng = np.random.default_rng(seed)
    p = init_params(img, cfg)
    params = {"pis": np.asarray(p.pis), "musX": np.asarray(p.musX),
              "A_diagonal": np.asarray(p.a_diag) * rng.uniform(
                  0.7, 1.3, p.a_diag.shape).astype(np.float32),
              "A_corr": np.tril(rng.normal(0, 1.0, p.a_corr.shape), -1
                                ).astype(np.float32),
              "nu_e": np.asarray(p.nu_e),
              "gamma_e": rng.normal(0, 0.1, p.gamma_e.shape
                                    ).astype(np.float32)}
    return quantize_params(params, cfg)


def _pool_files(tmp_path, seeds):
    """Files as a serving pool holds them: one geometry, each file's params
    the perturbed init of its own seed."""
    y, x = np.mgrid[0:24, 0:32] / 31.0
    img = np.stack([.5 + .3 * np.sin(5 * x), .5 + .3 * np.cos(4 * y),
                    .4 + .2 * np.sin(3 * (x + y))], -1).astype(np.float32)
    cfg = SmoeConfig(kernels_per_dim=(4, 4))
    paths = []
    for seed in seeds:
        path = str(tmp_path / f"pool{seed}.smoe")
        write_bitstream(path, _init_model(img, cfg, seed), cfg,
                        extra=_extra(img.shape[:2], 3, cfg))
        paths.append(path)
    return paths


def test_held_result_survives_the_next_decode(tmp_path):
    """Two files decoded in a row on the device at hand: the first image
    is bit for bit what it was after the second decode, and the two share
    no memory."""
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    first, second = _pool_files(tmp_path, (1, 2))
    a = decode_bitstream(first, device=device)
    kept = a.tobytes()
    b = decode_bitstream(second, device=device)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape \
        == (24, 32, 3)
    assert a.tobytes() != b.tobytes()
    assert a.tobytes() == kept
    assert not np.shares_memory(a, b)


def test_card_result_is_page_locked(tmp_path, monkeypatch):
    """On the card the image comes back in page-locked host memory, bit
    for bit the decoded tensor's pageable `.cpu()` copy."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smoe_tpu_torch.codec import serve
    pageable = []
    to_host = serve.to_host

    def spy(rec):
        pageable.append(rec.cpu().numpy())
        return to_host(rec)

    monkeypatch.setattr(serve, "to_host", spy)
    path, = _pool_files(tmp_path, (3,))
    rec = decode_bitstream(path, device="cuda")
    assert torch.from_numpy(rec).is_pinned()
    assert rec.dtype == np.float32 and rec.shape == pageable[0].shape
    assert rec.tobytes() == pageable[0].tobytes()


def test_lightfield_d4_views_match_jax(tmp_path):
    """d = 4 at small size: a light field's full decode and its view
    windows (views=)."""
    rng = np.random.default_rng(2)
    lf = rng.uniform(0.2, 0.8, (5, 5, 6, 6, 1)).astype(np.float32)
    cfg = SmoeConfig(dim_domain=4, num_channels=1, kernels_per_dim=(2,) * 4,
                     use_yuv=False)
    path = str(tmp_path / "lf.smoe")
    write_bitstream(path, _init_model(lf, cfg, 3), cfg,
                    extra=_extra(lf.shape[:4], 1, cfg))
    for kw in ({}, {"views": ((1, 2), (3, 4))}, {"views": ((0, 3), (2, 5))},
               {"views": ((0, 2), (1, 3)), "scale": 2.0}):
        assert_within_lsb(decode_bitstream(path, device="cpu", **kw),
                          j_decode(path, **kw))


def test_video_d3_frames_match_jax(tmp_path):
    """d = 3 without motion: the clip and a frame range (frames=)."""
    rng = np.random.default_rng(5)
    vid = rng.uniform(0.2, 0.8, (12, 12, 4, 3)).astype(np.float32)
    cfg = SmoeConfig(dim_domain=3, kernels_per_dim=(3, 3, 2))
    path = str(tmp_path / "vid.smoe")
    write_bitstream(path, _init_model(vid, cfg, 6), cfg,
                    extra=_extra(vid.shape[:3], 3, cfg))
    for kw in ({}, {"frames": (1, 3)}, {"roi": ((2, 10), (0, 6))}):
        assert_within_lsb(decode_bitstream(path, device="cpu", **kw),
                          j_decode(path, **kw))


def test_motion_video_decodes_like_jax(tmp_path):
    """A d = 3 file whose header carries motion rows (no dual-model mask):
    the raster is motion-transformed per call as the JAX decoder does,
    for the whole clip, a frame range and a window, on the kernel path's
    CPU version and the reference path (1 LSB)."""
    rng = np.random.default_rng(11)
    vid = rng.uniform(0, 1, (12, 10, 4, 3)).astype(np.float32)
    # train_trafo puts the init's kernels on the t = -5 motion plane
    cfg = SmoeConfig(dim_domain=3, kernels_per_dim=(3, 3, 2), num_frames=4,
                     num_params_model=6, train_trafo=True)
    motion = np.zeros((8, 4), np.float32)
    motion[0] = motion[4] = 1.0
    motion[2] = -0.05 * np.arange(4)
    motion[1] = 0.01 * np.arange(4)
    path = str(tmp_path / "motion.smoe")
    write_bitstream(path, _init_model(vid, cfg, 6), cfg, extra={
        **_extra(vid.shape[:3], 3, cfg), "motion": motion.tolist(),
        "num_params_model": 6, "num_frames": 4})
    # 1 LSB; 99 % identical: on the t = -5 plane the maha's products
    # cancel, so more of a 1,440-value clip sits on a rounding boundary of
    # the output quantizer than in a 2D decode
    for kw in ({}, {"frames": (1, 3)}, {"roi": ((2, 10), (0, 6))}):
        ref = j_decode(path, **kw)
        assert_within_lsb(decode_bitstream(path, device="cpu", **kw), ref,
                          min_identical=0.99)
        assert_within_lsb(decode_bitstream(path, device="cpu",
                                           reference=True, **kw), ref,
                          min_identical=0.99)
    moved = decode_bitstream(path, device="cpu")
    assert moved.std() > 0.01
    # the pan shows: frame 3 is not frame 0
    assert np.abs(moved[:, :, 3] - moved[:, :, 0]).max() > 1 / 255


def test_committed_fixture_matches_recorded_jax_decode():
    """Guards tests/data/bench512_k256.smoe and its recorded JAX decode
    (the card's only tie to the JAX package) against drift in either
    package."""
    from bench import build_image

    ref = np.load(FIXTURE_REF)
    stride = int(ref["stride"])
    img = build_image(512)
    rec_j = j_decode(FIXTURE)
    rec_t = decode_bitstream(FIXTURE, device="cpu")
    assert rec_t.shape == (512, 512, 3)
    assert_within_lsb(rec_t, rec_j)
    for rec in (rec_j, rec_t):
        diff = np.abs(_u8(rec[::stride, ::stride]) - ref["sample"])
        assert diff.max() <= 1
        psnr = psnr_from_mse(float(np.mean((rec - img) ** 2)) * 2 ** 16, 8)
        assert abs(psnr - float(ref["psnr_db"])) <= 0.01


def test_cli_png_matches_jax_cli(fitted, tmp_path):
    """`python -m smoe_tpu_torch.cli.decode --device cpu` writes the same
    PNG as the JAX package's decode CLI, to within 1 LSB."""
    from smoe_tpu.cli.decode import main as j_main

    j_main(["-p", fitted["flat"], "-r", str(tmp_path / "jax")])
    subprocess.run([sys.executable, "-m", "smoe_tpu_torch.cli.decode",
                    "-p", fitted["flat"], "-r", str(tmp_path / "torch"),
                    "--device", "cpu"], check=True, cwd=ROOT,
                   capture_output=True, timeout=300)
    want = cv2.imread(str(tmp_path / "jax" / "output.png"),
                      cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "torch" / "output.png"),
                     cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_cli_refuses_missing_gpu(fitted, tmp_path):
    """With --device cuda and no card the CLI fails; it does not fall
    back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from smoe_tpu_torch.cli.decode import main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["-p", fitted["flat"], "-r", str(tmp_path)])
    assert not os.path.exists(tmp_path / "output.png")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_yuv_to_bgr_matches_cv2(dtype):
    rng = np.random.default_rng(0)
    top = np.iinfo(dtype).max
    yuv = rng.integers(0, top + 1, (64, 80, 3)).astype(dtype)
    yuv[0, :8] = [[0, 0, 0], [top, top, top], [0, top, 0], [top, 0, top],
                  [0, 0, top], [top, top, 0], [top, 0, 0], [0, top, top]]
    np.testing.assert_array_equal(timages.yuv_to_bgr(yuv),
                                  cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR))


@pytest.mark.parametrize("precision,channels,yuv",
                         [(8, 3, True), (8, 3, False), (8, 1, False),
                          (16, 3, True)])
def test_write_image_matches_jax(precision, channels, yuv, tmp_path):
    """The port's numpy/zlib PNG writer against the JAX package's cv2
    writer, read back with cv2."""
    from smoe_tpu.io.images import write_image as j_write_image
    rng = np.random.default_rng(precision + channels)
    img = rng.uniform(0, 1, (23, 31, channels)).astype(np.float32)
    pj = j_write_image(img, str(tmp_path / "jax"), 2, yuv=yuv,
                       precision=precision)
    pt = timages.write_image(img, str(tmp_path / "torch"), 2, yuv=yuv,
                             precision=precision)
    want = cv2.imread(pj, cv2.IMREAD_UNCHANGED)
    got = cv2.imread(pt, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
