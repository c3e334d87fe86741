"""The port's classical-codec anchors (smoe_tpu_torch/apps/anchor_jpeg.py,
anchor_video.py, anchor_lf.py) against the JAX package's scripts, which
code with cv2's JPEG, on the CPU.

The JPEG rows are held exactly (bpp and dB as the scripts round them;
SSIM to its last printed digit, 1e-4: the port's SSIM map is JAX's eager
map bit for bit, but JAX means it in fp32 in XLA's own order, up to ~2e-6
off the port's, which moves a rounded 4th decimal where it straddles a
boundary):
on cut inputs against the scripts run here (64^2 families, two CIF
frames, a 5 x 5-view light field) and at the scripts' full sizes against
the rows tests/data/anchor_ref.json recorded from them
(scripts/make_torch_anchor_fixture.py), which chip_smoke.py's phase 26
holds the card's run to.  The SMoE row's composed encode of one set of
params is held to the script's exactly; its fit recipe is held on the card
(phase 26: the dem and mri rows against the recorded JAX CPU rows).
demo_superres's bicubic columns are held to the script's."""

import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401
cv2 = pytest.importorskip("cv2")

from smoe_tpu_torch.apps import (anchor_jpeg, anchor_lf,  # noqa: E402
                                 anchor_video, content, demo_superres)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR_REF = os.path.join(ROOT, "tests", "data", "anchor_ref.json")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_photo import script  # noqa: E402


def ref():
    with open(ANCHOR_REF) as f:
        return json.load(f)


def family_u8(fam, size):
    return np.uint8(content.build_family(fam, size) * 255)


def jpeg_only(rows, codec):
    return [r for r in rows if r["codec"] == codec]


SSIM_TOL = 1e-4


def same_rows(got, want):
    """Rows equal key for key, SSIM within its last printed digit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k == "ssim":
                assert abs(g[k] - w[k]) <= SSIM_TOL + 1e-9, (g, w)
            else:
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("family", ["mri"])
def test_jpeg_rows_equal_the_script_on_a_cut(family):
    img = family_u8(family, 64)
    n = int(np.prod(img.shape[:-1]))
    same_rows(anchor_jpeg.anchor_rows(img, n), jpeg_only(
        script("anchor_jpeg").anchor_rows(img, n), "jpeg"))


@pytest.mark.parametrize("texture", ["synth", "hopper"])
def test_video_rows_equal_the_script_on_two_frames(texture):
    vid, _ = content.build_video(moving_obj=True, texture=texture, t=2)
    frames = np.moveaxis((vid * 255).astype(np.uint8), 2, 0)
    n = int(np.prod(frames.shape[:3]))
    av = script("anchor_video")
    np.testing.assert_array_equal(anchor_video.to_yuv_float(frames),
                                  av.to_yuv_float(frames))
    assert anchor_video.per_frame_rows(
        frames, anchor_video.to_yuv_float(frames), n) == jpeg_only(
        av.per_frame_rows(frames, av.to_yuv_float(frames), n),
        "jpeg-per-frame")


@pytest.mark.parametrize("texture", ["synth", "hopper"])
def test_lf_rows_equal_the_script_on_5x5_views(texture):
    from smoe_tpu_torch.fit.blocks import _lf_train_mask
    lf = content.build_lf(s=24, texture=texture)[:5, :5, ..., 0]
    views = np.round(lf * 255.0).astype(np.uint8)
    tm = _lf_train_mask((15, 15))[:5, :5]
    n = int(np.prod(lf.shape))
    assert anchor_lf.per_view_rows(views, views / 255.0, tm, n) == \
        jpeg_only(script("anchor_lf").per_view_rows(views, views / 255.0,
                                                    tm, n), "jpeg-per-view")


def _main(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rows = mod.main(argv)
    printed = [json.loads(x) for x in out.getvalue().splitlines()]
    assert printed == rows
    assert "Blocked, not queued" in err.getvalue()
    return rows


@pytest.mark.parametrize("family", ["bench", "hopper", "mri", "dem"])
def test_anchor_jpeg_main_prints_the_recorded_rows(family):
    """`python -m smoe_tpu_torch.apps.anchor_jpeg --family F` at the
    script's 256: the rows scripts/anchor_jpeg.py printed (JPEG only), and
    the stderr notice naming the rows not emitted."""
    rows = _main(anchor_jpeg, ["--family", family, "--device", "cpu"])
    same_rows(rows, ref()["jpeg_rows"][family])


@pytest.mark.parametrize("texture", ["hopper"])
def test_anchor_video_main_prints_the_recorded_rows(texture):
    rows = _main(anchor_video, ["--texture", texture, "--device", "cpu"])
    assert rows == ref()["video_rows"][texture]


def test_anchor_lf_main_prints_the_recorded_rows():
    rows = _main(anchor_lf, ["--s", "24"])
    assert rows == ref()["lf_rows"]["synth"]


def test_anchor_jpeg_reads_a_file_as_imread_color(tmp_path):
    """The image argument: cv2.imread(IMREAD_COLOR) (tests/test_torch_jpeg.py
    holds read_color to it on JPEG with EXIF, PNG and PNM), here a 4:2:2
    JPEG of the photograph, against the script on the same file."""
    path = str(tmp_path / "x.jpg")
    bgr = np.ascontiguousarray(family_u8("hopper", 48)[..., ::-1])
    cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 80,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])
    rows = _main(anchor_jpeg, [path, "--device", "cpu"])
    u8 = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    want = jpeg_only(script("anchor_jpeg").anchor_rows(
        u8, int(np.prod(u8.shape[:-1]))), "jpeg")
    same_rows(rows, [{"family": "bench", **r} for r in want])


def test_smoe_row_auto_encode_is_the_scripts(monkeypatch):
    """--auto: the composed encode (anchors, the measured bit allocation,
    the RD prune) of one set of params, the port's 20-sweep fit of the
    bench family at 16^2 with 3 x 3 kernels, in both packages (the
    script's fit stubbed to hand over those params): the rows equal, SSIM
    within its last digit.
    Free-running, the two fits part by rounding and the allocation's
    discrete choices can part with them."""
    from smoe_tpu import Smoe as JSmoe
    img = family_u8("bench", 16)
    x = (img / 255.0).astype(np.float32)
    best = anchor_jpeg.fitted(x, 20, 3, 10, False, "cpu").get_params()
    monkeypatch.setattr(JSmoe, "ls_init_experts", lambda self, *a, **k: None)
    monkeypatch.setattr(JSmoe, "train", lambda self, *a, **k: None)
    monkeypatch.setattr(JSmoe, "get_best_params", lambda self: best)
    j = script("anchor_jpeg").smoe_row(img, 20, k=3, lsri=10, auto=True)
    from smoe_tpu_torch.fit.trainer import Smoe
    monkeypatch.setattr(anchor_jpeg, "fitted", lambda *a: Smoe(
        x, init_params_dict=best, bit_depths=(8, 10, 10, 10, 8),
        nu_anchor=True, device="cpu"))
    t = anchor_jpeg.smoe_row(img, 20, k=3, lsri=10, auto=True, device="cpu")
    same_rows([t], [j])


def test_superres_bicubic_is_the_scripts_resize():
    """demo_superres's bicubic baselines are cv2.resize(INTER_CUBIC) of the
    256 image: bit for bit with OpenCV's own code, and the script's
    psnr_bicubic_of_input_db column (cv2's default, IPP) to its 2
    decimals."""
    from test_torch_photo import opencv_resize
    lo, gt = content.build_image(256), content.build_image(512)
    got = demo_superres.bicubic(lo, (512, 512))
    with opencv_resize():
        want = cv2.resize(lo, (512, 512), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(got, want)
    ipp = cv2.resize(lo, (512, 512), interpolation=cv2.INTER_CUBIC)
    sr = script("demo_superres")
    assert round(demo_superres.psnr(got, gt), 2) == round(sr.psnr(ipp, gt),
                                                          2)
