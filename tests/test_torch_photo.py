"""PyTorch port: the real-photograph content (smoe_tpu_torch/apps/content.py,
apps/cv.py, apps/sample_data/) against the JAX package's scripts
(scripts/content.py, bench_video.py, bench_lf.py), which read matplotlib's
sample data and call OpenCV, both on the CPU.

Every build function's output, the committed copies and decodes, and
the numpy counterparts of cv2.resize(INTER_AREA), getRotationMatrix2D and
warpAffine(INTER_LINEAR, BORDER_REFLECT) are held bit for bit (no
tolerance).  cv2.resize(INTER_CUBIC), which the scripts upsize with, is
held bit for bit to OpenCV's own resize code (cv2.ipp.setUseIPP(False));
cv2's default hands it to Intel IPP, whose rounding the port does not
reproduce, and the upsized content is held to that within the bounds
stated at UPSIZED.  A 20-sweep fit of the photograph at 64^2 with 16 kernels,
each sweep taken by both packages from the JAX trainer's state: mse and
params within 1e-3 relative, lists equal.  The recorded JAX fit of
tests/data/hopper256_k144_ref.npz (scripts/make_torch_photo_fixture.py),
which chip_smoke.py holds the card to, is held here to the inputs it was
made from."""

import contextlib
import gzip
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401
cv2 = pytest.importorskip("cv2")
matplotlib = pytest.importorskip("matplotlib")

from smoe_tpu_torch.apps import content, cv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MPL_DATA = os.path.join(matplotlib.get_data_path(), "sample_data")
PHOTO_REF = os.path.join(ROOT, "tests", "data", "hopper256_k144_ref.npz")
ANCHOR_REF = os.path.join(ROOT, "tests", "data", "anchor_ref.json")
FIT_RTOL = 1e-3
_SCRIPTS = {}


def script(name):
    """scripts/<name>.py loaded as a module of its own (its main does not
    run)."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------- the committed sample data ----------------

@pytest.mark.parametrize("name", ["grace_hopper.jpg", "s1045.ima.gz",
                                  "jacksboro_fault_dem.npz"])
def test_sample_copies_are_byte_identical(name):
    with open(os.path.join(content.SAMPLE_DATA, name), "rb") as f:
        ours = f.read()
    with open(os.path.join(MPL_DATA, name), "rb") as f:
        theirs = f.read()
    assert ours == theirs
    readme = open(os.path.join(content.SAMPLE_DATA, "README.md")).read()
    assert sha256(ours) in readme


@pytest.mark.parametrize("gray", [False, True])
def test_hopper_decode_is_cv2_imread(gray):
    path = os.path.join(MPL_DATA, "grace_hopper.jpg")
    with open(path, "rb") as f:
        assert sha256(f.read()) in open(os.path.join(
            content.SAMPLE_DATA, "README.md")).read()
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                      else cv2.IMREAD_COLOR)
    got = content.hopper_photo(gray=gray)          # the port's decoder
    same(got, want)
    ref = json.load(open(ANCHOR_REF))["hopper_decode_sha256"]
    assert sha256(got.tobytes()) == ref["gray" if gray else "bgr"]


# ---------------- the build functions against the JAX scripts ----------

@pytest.mark.parametrize("size", [256, 48])
@pytest.mark.parametrize("family", ["hopper", "mri", "dem"])
def test_photo_family_is_bit_identical(family, size):
    same(content.build_family(family, size),
         script("content").build_family(family, size))


@pytest.mark.parametrize("kw", [{"texture": "hopper"},
                                {"moving_obj": True, "rot": 5.0},
                                {"moving_obj": True, "texture": "hopper",
                                 "rot": 5.0}])
def test_photo_video_is_bit_identical(kw):
    tv, ta = content.build_video(**kw)
    jv, ja = script("bench_video").build_video(**kw)
    same(tv, jv)
    same(ta, ja)


@pytest.mark.parametrize("s", [24, 48])
def test_photo_lf_is_bit_identical(s):
    same(content.build_lf(s=s, texture="hopper"),
         script("bench_lf").build_lf(s=s, texture="hopper"))


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown content family"):
        content.build_family("nope", 32)


# ---------------- the cv2 counterparts ----------------

@pytest.mark.parametrize("angle", [5.0, 35.0, -123.4])
def test_warp_affine_is_cv2(angle):
    rng = np.random.default_rng(1)
    img = rng.random((56, 61, 3)).astype(np.float32)
    for center, scale, size in ((((56 - 1) / 2, (56 - 1) / 2), 1.0,
                                 (56, 56)), ((3.3, -2.0), 0.8, (70, 45))):
        m = cv2.getRotationMatrix2D(center, angle, scale)
        np.testing.assert_array_equal(cv.rotation_matrix(center, angle,
                                                         scale), m)
        same(cv.warp_affine_linear_reflect(img, m, size),
             cv2.warpAffine(img, m, size, flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_REFLECT))
        same(cv.warp_affine_linear_reflect(img[..., 0].copy(), m, size),
             cv2.warpAffine(img[..., 0].copy(), m, size,
                            flags=cv2.INTER_LINEAR,
                            borderMode=cv2.BORDER_REFLECT))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("factor", ["integer", "fraction"])
def test_resize_area_is_cv2(dtype, factor):
    rng = np.random.default_rng(2)
    sizes = ([(60, 45), (30, 15), (15, 15)] if factor == "integer"
             else [(48, 48), (119, 89), (7, 30)])
    for shape in ((90, 120, 3), (90, 120), (90, 120, 4)):
        img = (rng.integers(0, 256, shape).astype(np.uint8)
               if dtype == np.uint8
               else (rng.random(shape) * 300).astype(np.float32))
        for size in sizes:
            same(cv.resize_area(img, size),
                 cv2.resize(img, size, interpolation=cv2.INTER_AREA))


@contextlib.contextmanager
def opencv_resize():
    """cv2 with Intel IPP off: its resize runs OpenCV's own code."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


# where the scripts upsize (INTER_CUBIC): (the port's build, the script's,
# the largest difference from cv2's default IPP resize, measured here:
# hopper 1024 one value in 3e6 by 1/255, mri 1.8e-7, dem 3.0e-7, the light
# field's photograph 2.5e-5, the wide clip's canvas 1/255)
UPSIZED = {
    "hopper_1024": (lambda: content.build_hopper(1024),
                    lambda: script("content").build_hopper(1024), 1 / 255),
    "mri_512": (lambda: content.build_mri(512),
                lambda: script("content").build_mri(512), 5e-7),
    "dem_512": (lambda: content.build_dem(512),
                lambda: script("content").build_dem(512), 5e-7),
    "lf_hopper_views3_s480": (
        lambda: content.build_lf(views=3, s=480, texture="hopper"),
        lambda: script("bench_lf").build_lf(views=3, s=480,
                                            texture="hopper"), 5e-5),
    "video_hopper_w600": (
        lambda: content.build_video(w=600, t=2, texture="hopper")[0],
        lambda: script("bench_video").build_video(w=600, t=2,
                                                  texture="hopper")[0],
        1.001 / 255)}


@pytest.mark.parametrize("name", sorted(UPSIZED))
def test_upsizing_matches_jax_scripts(name):
    """The content the scripts upsize with cv2's INTER_CUBIC: bit for bit
    against the script through OpenCV's own resize code, and within the
    stated bound of the script on cv2's default (IPP)."""
    port, jax_script, bound = UPSIZED[name]
    got = port()
    with opencv_resize():
        same(got, jax_script())
    diff = np.abs(got.astype(np.float64) - jax_script())
    assert diff.max() <= bound, diff.max()


@pytest.mark.parametrize("name", ["hopper_1024", "mri_512", "dem_512"])
def test_recorded_upsized_sha256(name):
    """The sha256 chip_smoke.py's phase 26 holds the card's build to,
    recorded from the JAX scripts by scripts/make_torch_anchor_fixture.py
    (OpenCV's own resize code)."""
    ref = json.load(open(ANCHOR_REF))["upsized_sha256"]
    assert sha256(np.ascontiguousarray(UPSIZED[name][0]()).tobytes()) \
        == ref[name]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,size", [
    ((512, 512, 3), (1024, 1024)), ((256, 256), (512, 512)),
    ((344, 344), (512, 512)), ((600, 512), (626, 734)),
    ((288, 372, 3), (600, 465)), ((7, 5, 3), (16, 13)), ((1, 1), (3, 2)),
    ((9, 30), (41, 31))], ids=str)
def test_resize_cubic_is_opencv(dtype, shape, size):
    """cv.resize_cubic against cv2.resize(INTER_CUBIC) in OpenCV's own
    code, bit for bit, at the content's scale factors and odd ones (the
    vertical pass's vector steps and scalar tail both covered)."""
    rng = np.random.default_rng(sum(shape) + size[0])
    img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else rng.random(shape).astype(np.float32))
    with opencv_resize():
        same(cv.resize_cubic(img, size),
             cv2.resize(img, size, interpolation=cv2.INTER_CUBIC))


def test_resize_area_refuses_upsizing():
    with pytest.raises(ValueError, match="resize_cubic"):
        cv.resize_area(np.zeros((8, 8), np.float32), (9, 8))


# ---------------- the recorded JAX fit's inputs ----------------

_REF = np.load(PHOTO_REF)
_NAMES = [str(n) for n in _REF["input_names"]]


@pytest.mark.parametrize("name", _NAMES)
def test_recorded_input_sha256(monkeypatch, name):
    """The port's photo inputs as chip_smoke.py's phase 25 builds them
    (`photo_inputs`) against the sha256 the fixture recorded from the JAX
    scripts, which phase 25 holds the card's build functions to."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    got = chip_smoke.photo_inputs()
    assert sorted(got) == sorted(_NAMES)
    i = _NAMES.index(name)
    assert str(got[name].shape) == str(_REF["input_shapes"][i])
    assert chip_smoke.sha_of(got[name]) == str(_REF["input_sha256"][i])


# ---------------- a small fit of the photograph ----------------

def test_small_photo_fit_tracks_jax():
    """build_hopper(64), 4 x 4 kernels, YUV loss, determinant gating: 20
    sweeps of the JAX package on the CPU, each also taken by the port's CPU
    path from the JAX trainer's state (params, lists, Adam moments carried
    over): the sweep's mse within 1e-3 relative, the updated params within
    1e-3 of their largest value, num_pi and the lists equal.  (Free-running,
    the two fits part by ulp-level roundings that 4 x 4 kernels on a
    photograph amplify: 6e-4 at sweep 18, 1.3e-3 at sweep 19.)"""
    from smoe_tpu.fit.trainer import Smoe as JSmoe
    from smoe_tpu_torch.fit.trainer import Smoe
    from test_torch_video import carry
    img = content.build_hopper(64)
    kw = dict(kernels_per_dim=[4], use_yuv=True, use_determinant=True)
    js = JSmoe(img, **kw)
    js.set_optimizer()
    ts = Smoe(img, device="cpu", **kw)
    ts.set_optimizer()
    mse = []
    for i in range(20):
        if i:
            carry(js, ts)
        _, tm, tn, _ = ts.run_batched_chunk(1)
        _, jm, jn, _ = js.run_batched_chunk(1)
        np.testing.assert_allclose(tm, np.asarray(jm), rtol=FIT_RTOL)
        np.testing.assert_array_equal(tn, np.asarray(jn))
        np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                      np.asarray(js.kernel_lists))
        tp, jp = ts.get_params(), js.get_params()
        for k in ("musX", "A_diagonal", "A_corr", "nu_e", "gamma_e",
                  "pis"):
            np.testing.assert_allclose(
                tp[k], jp[k], rtol=0,
                atol=FIT_RTOL * np.abs(jp[k]).max(), err_msg=k)
        mse.append(float(tm[0]))
    assert np.isfinite(mse).all() and mse[-1] < mse[0]


def test_mri_reads_the_big_endian_slice():
    """The slice's values are 0..215 (the native-order read peaks at
    215 << 8), so the family divides by 215."""
    with gzip.open(os.path.join(content.SAMPLE_DATA, "s1045.ima.gz")) as f:
        a = np.frombuffer(f.read(), ">u2")
    assert a.max() == 215
    np.testing.assert_array_equal(content.build_mri(256)[..., 0],
                                  (a.reshape(256, 256) / 215.0)
                                  .astype(np.float32))
