"""PyTorch port: 4D light fields (io/images.py `.mat` in and out, the
blocked corner-view mask and its float weight in fit/blocks.py, the
trainer, fit/lsinit.py's row weights, the logger, and the fit ->
reconstruct -> decode CLIs on a `.mat`) against the JAX package on the CPU.

Every case of tests/test_lightfield.py runs on the port and is held
against JAX on the same numpy inputs (tests/test_lightfield.py's
`make_lf`: 15 x 15 views of 6 x 6, grayscale).  Tolerances, stated where
they apply:
  * `.mat` reads: the arrays equal JAX's read_image, bit for bit (uint8 and
    uint16 RGB through the integer YUV path); a float32 RGB light field to
    1.2e-7 (OpenCV's vector loop rounds the last bit of some values
    otherwise than its scalar loop, which the port follows);
  * masks: equal;
  * trajectories: per-sweep loss and mse rtol 2e-3 over 10 sweeps (the
    trainer tests' tolerance: the output fake-quantizer rounds), num_pi
    and the lists equal; one step from one init rtol 1e-4 / atol 1e-3 of
    each group's learning rate (Adam's first step, lr g / (|g| + eps));
  * the LS solve under the corner weight: experts 1e-4 of max |x| (per
    kernel), the eval mse 2e-3, as tests/test_torch_lsinit.py;
  * the CLIs: the first validation after the LS solve within 1e-3 of JAX's
    (the solve's conditioning); the automatic encode's choices equal and
    its `.smoe` byte-identical from JAX's params; decodes within 1 LSB.
"""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.fit.blocks import _lf_train_mask as j_lf_mask  # noqa: E402
from smoe_tpu.fit.blocks import build_blockset as jbuild  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.io.images import read_image as jread  # noqa: E402
from smoe_tpu.io.images import write_image as jwrite  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.fit.blocks import _lf_train_mask  # noqa: E402
from smoe_tpu_torch.fit.blocks import build_blockset  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_lightfield import make_lf  # noqa: E402

RTOL = 2e-3
KPD = [2, 2, 2, 2]
BLOCKED = (5, 15, 6, 6)


def _pair(img, **kw):
    kw = {"kernels_per_dim": KPD, "use_yuv": False, **kw}
    js, ts = JSmoe(img, **kw), Smoe(img, device="cpu", **kw)
    js.set_optimizer()
    ts.set_optimizer()
    return js, ts


def _run(main, args):
    """(main's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(args)
    return out, buf.getvalue()


# ---------------- the mask and the blocks ----------------

def test_lf_train_mask_is_jax_s():
    m = _lf_train_mask((15, 15, 6, 6))
    np.testing.assert_array_equal(m, j_lf_mask((15, 15, 6, 6)))
    assert not m[0, 0].any() and not m[14, 14].any() and m[7, 7].all()


@pytest.mark.parametrize("cw", [0.0, 0.25, 0.3])
@pytest.mark.parametrize("bs", [None, BLOCKED], ids=["one_block", "blocked"])
def test_lf_blockset_mask_matches_jax(cw, bs):
    """The blocked view mask: bool at cw = 0, the float weight otherwise,
    equal to JAX's in one block and in the blocked layout."""
    lf = make_lf()
    kw = dict(dim_domain=4, num_channels=1, kernels_per_dim=(2, 2, 2, 2),
              use_yuv=False, lf_corner_weight=cw)
    shape = bs or lf.shape[:4]
    tm = build_blockset(lf, SmoeConfig(**kw), shape).train_mask.numpy()
    jm = np.asarray(jbuild(lf, JConfig(**kw), shape).train_mask)
    assert tm.dtype == jm.dtype == (np.float32 if cw else np.bool_)
    np.testing.assert_array_equal(tm, jm)
    full = _lf_train_mask(lf.shape[:4])
    assert np.isclose(tm.astype(np.float32).mean(),
                      full.mean() + cw * (1 - full.mean()), atol=1e-6)
    if cw:
        assert set(np.unique(tm)) == {np.float32(cw), np.float32(1.0)}


def _one_step(img, cw):
    """tests/test_lightfield.py's fit_one_step in both packages: the
    blocked layout, one eval, one sweep."""
    out = []
    for cls, extra in ((JSmoe, {}), (Smoe, {"device": "cpu"})):
        s = cls(img, kernels_per_dim=KPD, use_yuv=False, batch_size=BLOCKED,
                lf_corner_weight=cw, **extra)
        s.set_optimizer()
        l0 = s.run_batched(train=False)[0]
        s.run_batched_chunk(1)
        out.append((l0, s.get_params()))
    return out


@pytest.mark.parametrize("cw", [0.0, 0.3])
def test_corner_views_in_the_loss(cw):
    """cw = 0: corrupting only the corner views changes neither the loss
    nor the one-step params (bit for bit); cw = 0.3: it changes both.  The
    port's step equals JAX's either way."""
    lf = make_lf()
    lf2 = lf.copy()
    lf2[~_lf_train_mask(lf.shape[:4])] = 0.93
    (jl1, jp1), (tl1, tp1) = _one_step(lf, cw)
    (jl2, jp2), (tl2, tp2) = _one_step(lf2, cw)
    if cw == 0.0:
        assert tl1 == tl2
        for k in tp1:
            np.testing.assert_array_equal(tp1[k], tp2[k])
    else:
        assert tl1 != tl2
        assert any(not np.array_equal(tp1[k], tp2[k]) for k in tp1)
    # Adam's first step is lr * g / (|g| + eps): where |g| is near eps the
    # step moves by the gradients' relative difference, so each field is
    # held to 1e-3 of its group's learning rate (A: 1e-3 x 1000)
    lr = {"A_diagonal": 1.0, "A_corr": 1.0, "pis": 1e-5}
    for (jl, jp), (tl, tp) in (((jl1, jp1), (tl1, tp1)),
                               ((jl2, jp2), (tl2, tp2))):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4,
                                       atol=1e-3 * lr.get(k, 1e-3))


def test_zero_weight_is_reference_parity():
    lf = make_lf()
    l0 = Smoe(lf, kernels_per_dim=KPD, use_yuv=False,
              device="cpu").run_batched(train=False)[0]
    lz = Smoe(lf, kernels_per_dim=KPD, use_yuv=False, device="cpu",
              lf_corner_weight=0.0).run_batched(train=False)[0]
    assert l0 == lz


@pytest.mark.parametrize("case", [
    "one_block", "one_block_cw", "blocked", "blocked_cw", "fused_cw"])
def test_lf_sweeps_track_jax(case):
    """10 sweeps of the d = 4 fit (tests/test_lightfield.py
    test_lf_fit_end_to_end) in both packages from one init: per-sweep loss
    and mse, num_pi and the lists; "fused_cw" routes the port's sweep
    through the fused op (use_pallas="on", the kernels' plain versions on
    the CPU) and JAX's through Pallas in interpret mode."""
    kw = {"one_block": {}, "one_block_cw": dict(lf_corner_weight=0.3),
          "blocked": dict(batch_size=BLOCKED),
          "blocked_cw": dict(batch_size=BLOCKED, lf_corner_weight=0.3),
          "fused_cw": dict(use_pallas="on", lf_corner_weight=0.1)}[case]
    js, ts = _pair(make_lf(), **kw)
    j0, t0 = js.run_batched(train=False), ts.run_batched(train=False)
    np.testing.assert_allclose(t0[:2], j0[:2], rtol=1e-5)
    jl, jm, jn, _ = js.run_batched_chunk(10)
    tl, tm, tn, _ = ts.run_batched_chunk(10)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tm, jm, rtol=RTOL)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    assert np.isfinite(tl).all() and tm[-1] < t0[1]


def test_corner_weight_reaches_every_loss_the_same_way():
    """At cw = 0.3 the kernel path's training loss, the light eval (fused
    op), the eval with the reconstruction and the quantized eval (plain)
    see the float mask alike: fused and plain agree, and equal JAX's."""
    lf = make_lf()
    out = {}
    for mode in ("on", "off"):
        js, ts = _pair(lf, use_pallas=mode, lf_corner_weight=0.3,
                       batch_size=BLOCKED, quantization_mode=1)
        vals = {}
        for name, s in (("jax", js), ("torch", ts)):
            light = s.run_batched(train=False)[0]
            rec = s.run_batched(train=False, update_reconstruction=True)[0]
            if name == "jax":
                from smoe_tpu.codec.quantize import quantize_params, rescaler
                s.qparams = quantize_params(s.get_params(), s.cfg)
                s.rparams = rescaler(s.qparams, s.cfg)
            else:
                s._quantize_now()
            quant = s.run_batched(train=False,
                                  with_quantized_params=True)[0]
            train = float(s.run_batched_chunk(1)[0][0])
            vals[name] = [light, rec, quant, train]
        np.testing.assert_allclose(vals["torch"], vals["jax"], rtol=1e-5)
        out[mode] = vals["torch"]
    np.testing.assert_allclose(out["on"], out["off"], rtol=1e-5)
    # the corner views enter at 0.3: not the cw = 0 loss
    s0 = Smoe(lf, kernels_per_dim=KPD, use_yuv=False, device="cpu",
              batch_size=BLOCKED)
    assert s0.run_batched(train=False)[0] != pytest.approx(out["off"][0],
                                                           rel=1e-4)


@pytest.mark.parametrize("cw", [0.1, 0.3])
@pytest.mark.parametrize("mode", ["kernel", "coupled"])
def test_ls_init_respects_corner_weight(mode, cw):
    """The LS solve's row weights carry the float mask (lsinit.py:142,
    347): the experts and the eval after the solve equal JAX's at the
    recipe's cw 0.1 and at 0.3, and differ from the cw = 0 solve."""
    lf = make_lf()
    js, ts = _pair(lf, lf_corner_weight=cw, batch_size=BLOCKED)
    for s in (js, ts):
        s.ls_init_experts(mode=mode)
    xj = np.concatenate([np.asarray(js.params.nu_e).ravel(),
                         np.asarray(js.params.gamma_e).ravel()])
    xt = np.concatenate([ts.params.nu_e.detach().numpy().ravel(),
                         ts.params.gamma_e.detach().numpy().ravel()])
    tol = 1e-4 if mode == "kernel" else 1e-3
    np.testing.assert_allclose(xt, xj, atol=tol * np.abs(xj).max())
    j, t = js.run_batched(train=False), ts.run_batched(train=False)
    assert np.isfinite(t[0]) and np.isfinite(t[1])
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL)
    s0 = Smoe(lf, kernels_per_dim=KPD, use_yuv=False, device="cpu",
              batch_size=BLOCKED)
    s0.ls_init_experts(mode=mode)
    assert not np.allclose(s0.params.nu_e.detach().numpy(),
                           ts.params.nu_e.detach().numpy())


# ---------------- .mat in and out ----------------

def _rgb_lf(dtype):
    lf = np.repeat(make_lf(c=1), 3, axis=-1)
    lf[..., 1] = 1.0 - lf[..., 1]
    lf[..., 2] *= 0.5
    if dtype == np.float32:
        return lf.astype(np.float32)
    return np.round(lf * np.iinfo(dtype).max).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("use_yuv", [True, False])
def test_mat_read_matches_jax(tmp_path, dtype, use_yuv):
    """A v5 `.mat` RGB light field: the port's read_image gives JAX's
    array (RGB -> YUV per view when use_yuv) and precision."""
    from scipy.io import savemat
    path = str(tmp_path / "lf.mat")
    savemat(path, {"LF": _rgb_lf(dtype)})
    got, prec, aff = timg.read_image(path, use_yuv=use_yuv)
    want, jprec, _ = jread(path, use_yuv=use_yuv)
    assert got.shape == want.shape == (15, 15, 6, 6, 3)
    assert got.dtype == np.float32 and prec == jprec and aff is None
    if dtype == np.float32 and use_yuv:
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_mat_roundtrip_matches_jax(tmp_path):
    """tests/test_lightfield.py test_lf_mat_io_roundtrip: the port writes
    the `.mat` JAX writes (the same LF array, YUV -> RGB per view), and
    reads it back as JAX does."""
    from scipy.io import loadmat
    lf3 = np.repeat(make_lf(c=1), 3, axis=-1)
    for yuv in (False, True):
        a = timg.write_image(lf3, str(tmp_path / f"t{yuv}"), 4, yuv=yuv,
                             precision=8)
        b = jwrite(lf3, str(tmp_path / f"j{yuv}"), 4, yuv=yuv, precision=8)
        assert a.endswith(".mat") and b.endswith(".mat")
        np.testing.assert_array_equal(loadmat(a)["LF"], loadmat(b)["LF"])
        back, precision, _ = timg.read_image(a, use_yuv=False)
        assert precision == 8 and back.shape == lf3.shape
        np.testing.assert_array_equal(back, jread(a, use_yuv=False)[0])
        if not yuv:
            np.testing.assert_allclose(back, lf3, atol=1.5 / 255)
    a = timg.write_image(lf3, str(tmp_path / "t16"), 4, yuv=True,
                         precision=16)
    b = jwrite(lf3, str(tmp_path / "j16"), 4, yuv=True, precision=16)
    np.testing.assert_array_equal(loadmat(a)["LF"], loadmat(b)["LF"])


def _v73_file(path, lf8):
    """tests/test_lightfield.py's genuine v7.3 layout: a 512-byte MATLAB
    userblock and an HDF5 payload with reversed axes."""
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w", userblock_size=512) as f:
        f["LF"] = lf8.transpose()
    header = b"MATLAB 7.3 MAT-file, written by smoe_tpu tests"
    block = header + b" " * (124 - len(header)) \
        + np.uint16(0x0200).tobytes() + b"IM"
    with open(path, "r+b") as fd:
        fd.write(block)


def test_mat_v73_read_matches_jax(tmp_path):
    from scipy.io import loadmat
    lf8 = np.round(_rgb_lf(np.float32) * 255).astype(np.uint8)
    path = str(tmp_path / "lf73.mat")
    _v73_file(path, lf8)
    with pytest.raises(NotImplementedError):
        loadmat(path)
    for use_yuv in (False, True):
        got, precision, _ = timg.read_image(path, use_yuv=use_yuv)
        want, _, _ = jread(path, use_yuv=use_yuv)
        assert precision == 8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timg.read_mat(path), lf8)


def test_mat_v73_write_roundtrip(tmp_path):
    """write_image(mat_v73=True): a v7.3 container scipy refuses, read back
    by both packages exactly."""
    pytest.importorskip("h5py")
    from scipy.io import loadmat
    lf = np.repeat(make_lf(c=1), 3, axis=-1)
    out = timg.write_image(lf, str(tmp_path / "lf73w"), 4, yuv=False,
                           precision=8, mat_v73=True)
    with pytest.raises(NotImplementedError):
        loadmat(out)
    back, precision, _ = timg.read_image(out, use_yuv=False)
    assert back.shape == lf.shape and precision == 8
    np.testing.assert_allclose(back, np.round(lf * 255) / 255.0, atol=1e-6)
    np.testing.assert_array_equal(back, jread(out, use_yuv=False)[0])
    ref = jwrite(lf, str(tmp_path / "j73w"), 4, yuv=False, precision=8,
                 mat_v73=True)
    np.testing.assert_array_equal(timg.read_mat(out), timg.read_mat(ref))


def test_mat_v73_without_h5py_names_the_conversion(tmp_path, monkeypatch):
    lf8 = np.zeros((15, 15, 2, 2, 1), np.uint8)
    path = str(tmp_path / "lf73.mat")
    _v73_file(path, lf8)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ValueError, match="savemat"):
        timg.read_image(path)


# ---------------- the logger ----------------

@pytest.mark.parametrize("d", [3, 4])
def test_logger_writes_media_as_jax(tmp_path, d):
    """ModelLogger writes a video's reconstruction as `.yuv` and a light
    field's as `.mat` (log.py:47-57), with the bytes / the array JAX's
    logger writes; an odd-sized video falls back to `.npy`."""
    from scipy.io import loadmat
    from smoe_tpu.diag.log import ModelLogger as JLog
    from smoe_tpu_torch.diag.log import ModelLogger as TLog
    rng = np.random.default_rng(0)
    shape = (4, 6, 3, 3) if d == 3 else (15, 15, 2, 2, 1)
    rec = rng.uniform(0, 1, shape).astype(np.float32)

    class Fake:
        cfg = SmoeConfig(dim_domain=d, num_channels=shape[-1],
                         use_yuv=d == 3)

    ext = ".yuv" if d == 3 else ".mat"
    paths = []
    for name, cls in (("j", JLog), ("t", TLog)):
        log = cls(str(tmp_path / name))
        p = str(tmp_path / name / "reconstructions" / "5")
        log._write(rec, p, Fake())
        assert os.path.exists(p + ext)
        paths.append(p + ext)
    if d == 3:
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
        p = str(tmp_path / "t" / "reconstructions" / "odd")
        TLog(str(tmp_path / "t"))._write(rec[:3], p, Fake())
        assert os.path.exists(p + ".npy")
    else:
        np.testing.assert_array_equal(loadmat(paths[0])["LF"],
                                      loadmat(paths[1])["LF"])


# ---------------- the CLIs ----------------

RECIPE = ["-k", "2", "2", "2", "2", "-lr", "5e-4", "-np", "0", "-qm", "1",
          "-iukl", "1", "-pmt", "100", "-pg", "5", "-lsinit", "kernel",
          "-nuanchor", "1", "-lsri", "4", "-lfcw", "0.1", "-n", "8", "-v",
          "4"]


@pytest.fixture(scope="module")
def lf_cli(tmp_path_factory):
    """scripts/bench_lf.py's recipe (fit flags as bench_lf.py:140-170
    builds them, cut to 8 sweeps) through both fit CLIs on make_lf() as a
    float32 `.mat`, then both reconstruct CLIs (the automatic encode) on
    JAX's params_best.pkl."""
    from scipy.io import savemat
    from smoe_tpu.cli import fit as jfit
    from smoe_tpu.cli import reconstruct as jrec
    from smoe_tpu_torch.cli import fit as tfit
    from smoe_tpu_torch.cli import reconstruct as trec
    root = tmp_path_factory.mktemp("lfcli")
    mat = str(root / "lf.mat")
    savemat(mat, {"LF": make_lf()})
    out = {"mat": mat, "root": root}
    for pkg, main, extra in (("jax", jfit.main, []),
                             ("torch", tfit.main, ["--device", "cpu"])):
        d = str(root / f"fit_{pkg}")
        smoe, log = _run(main, ["-i", mat, "-r", d] + RECIPE + extra)
        out["fit", pkg] = (smoe, d, log)
    pkl = os.path.join(out["fit", "jax"][1], "params_best.pkl")
    for pkg, main, extra in (("jax", jrec.main, []),
                             ("torch", trec.main, ["--device", "cpu"])):
        d = str(root / f"rec_{pkg}")
        rec, log = _run(main, ["-i", mat, "-p", pkl, "-r", d] + extra)
        out["rec", pkg] = (np.asarray(rec), d, log)
    return out


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as fd:
        return [json.loads(line) for line in fd]


def test_lf_fit_cli_tracks_jax(lf_cli):
    """The d = 4 fit from a `.mat`: the same validations and kernel
    counts, the first (right after the LS solve) within 1e-3 of JAX's, both
    improving on it; `.mat` reconstructions per validation and
    model_best.smoe written."""
    (ts, td, tlog), (js, jd, _) = lf_cli["fit", "torch"], lf_cli["fit",
                                                                  "jax"]
    assert ts.cfg.dim_domain == 4 and ts.cfg.lf_corner_weight == 0.1
    assert ts.bset.train_mask.dtype == torch.float32
    j, t = _metrics(jd), _metrics(td)
    assert [r["iter"] for r in t] == [r["iter"] for r in j] == [0, 4, 8]
    assert [r["num_kernels"] for r in t] == [r["num_kernels"] for r in j]
    np.testing.assert_allclose(t[0]["mse"], j[0]["mse"], rtol=1e-3)
    for rows in (j, t):
        assert min(r["mse"] for r in rows[1:]) < rows[0]["mse"]
    names = set(os.listdir(td))
    assert {"model_best.smoe", "model_last.smoe", "params_best.pkl"} <= names
    recs = set(os.listdir(os.path.join(td, "reconstructions")))
    assert {"0.mat", "4.mat", "8.mat", "8_q.mat"} <= recs
    assert "-iukl 1 is strongly recommended" not in tlog


def test_lf_fit_without_in_graph_lists_warns(lf_cli, tmp_path):
    from smoe_tpu_torch.cli import fit as tfit
    _, log = _run(tfit.main, ["-i", lf_cli["mat"], "-r", str(tmp_path),
                              "-k", "2", "-n", "0", "--device", "cpu"])
    assert "-iukl 1 is strongly recommended" in log


def test_lf_encode_is_jax_s(lf_cli):
    """reconstruct's automatic encode of JAX's params_best.pkl on the
    `.mat`: the same depths, anchors and prune point, a byte-identical
    model.smoe, the reconstruction within 1 LSB, written as `.mat`."""
    from scipy.io import loadmat
    (trec, td, tlog), (jrec, jd, jlog) = lf_cli["rec", "torch"], \
        lf_cli["rec", "jax"]
    pat = r"auto-bd: (\[[^\]]*\]) nu_anchor=(\d) gamma_anchor=(\d)"
    assert re.search(pat, tlog).groups() == re.search(pat, jlog).groups()
    keep = r"prune: keeping (\d+)/(\d+) kernels"
    assert re.search(keep, tlog).groups() == re.search(keep, jlog).groups()
    with open(os.path.join(td, "model.smoe"), "rb") as a, \
            open(os.path.join(jd, "model.smoe"), "rb") as b:
        assert a.read() == b.read()
    assert trec.shape == jrec.shape == (15, 15, 6, 6, 1)
    assert np.abs(trec - jrec).max() <= 1.01 / 255
    np.testing.assert_array_equal(loadmat(os.path.join(td, "output.mat"))
                                  ["LF"], loadmat(os.path.join(
                                      jd, "output.mat"))["LF"])


def test_lf_decode_cli(lf_cli, tmp_path):
    """cli.decode of the d = 4 `.smoe` and of the qparams pickle: `.mat`
    outputs within 1 LSB of the encoder's reconstruction and of JAX's
    decode; a views= decode is the slice of the full one."""
    from scipy.io import loadmat
    from smoe_tpu.cli import decode as jdec
    from smoe_tpu_torch.cli import decode as tdec
    from smoe_tpu_torch.codec.serve import decode_bitstream
    rec, d, _ = lf_cli["rec", "torch"]
    smoe = os.path.join(d, "model.smoe")
    dec = np.asarray(_run(tdec.main, ["-p", smoe, "-r", str(tmp_path / "b"),
                                      "--device", "cpu"])[0])
    jd = np.asarray(_run(jdec.main, ["-p", smoe, "-r",
                                     str(tmp_path / "j")])[0])
    for other in (rec, jd):
        diff = np.abs(np.round(dec * 255) - np.round(other * 255))
        assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    lf_t = loadmat(str(tmp_path / "b" / "output.mat"))["LF"]
    assert lf_t.shape == (15, 15, 6, 6, 1) and lf_t.dtype == np.uint8
    part = decode_bitstream(smoe, device="cpu", views=((3, 9), (2, 5)))
    np.testing.assert_array_equal(part, dec[3:9, 2:5])
    pk = np.asarray(_run(tdec.main, ["-p", os.path.join(d, "qparams.pkl"),
                                     "-r", str(tmp_path / "p"), "--device",
                                     "cpu"])[0])
    np.testing.assert_allclose(pk, rec, atol=1e-6)
    assert os.path.exists(str(tmp_path / "p" / "output.mat"))


def test_lf_fit_model_best_is_byte_identical_from_jax_params(lf_cli,
                                                            tmp_path):
    import dataclasses
    from smoe_tpu_torch.cli import fit as tfit
    from smoe_tpu_torch.codec.container import load_params
    js, d, _ = lf_cli["fit", "jax"]
    cfg = SmoeConfig(**{f.name: getattr(js.cfg, f.name)
                        for f in dataclasses.fields(SmoeConfig)})
    best = load_params(os.path.join(d, "params_best.pkl"))
    out = str(tmp_path / "model_best.smoe")
    tfit.write_model(out, best, cfg, js.image.shape)
    with open(out, "rb") as a, \
            open(os.path.join(d, "model_best.smoe"), "rb") as b:
        assert a.read() == b.read()


# ---------------- the card's light field and the recorded JAX fit -------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_script_lf_is_bench_lf_s():
    """chip_smoke.build_lf is scripts/bench_lf.py's synth light field."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from bench_lf import build_lf
    for s in (6, 12):
        np.testing.assert_array_equal(chip_smoke.build_lf(s=s),
                                      build_lf(views=15, s=s))


def test_recorded_lf_recipe_is_reproduced_on_the_cpu(monkeypatch):
    """The recipe's trainer on the cut light field (chip_smoke.lf_smoe, the
    trainer cli.fit builds for bench_lf.py's flags) against the JAX run
    recorded in tests/data/lf_cut_ref.npz: the per-kernel LS experts to
    1e-3 of max (576 solves), the eval after them 1e-5, 20 sweeps' mse
    2e-3, num_pi and lists equal; the recorded JAX .smoe decodes within
    1 LSB of the recorded decode."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from smoe_tpu_torch.codec.serve import decode_bitstream
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    ref = np.load(chip_smoke.LF_REF)
    lf = chip_smoke.build_lf(s=int(ref["s"]))
    s = chip_smoke.lf_smoe(lf, "off")
    s.ls_init_experts(mode="kernel")
    x = np.concatenate([s.params.nu_e.detach().numpy().ravel(),
                        s.params.gamma_e.detach().numpy().ravel()])
    xr = np.concatenate([ref["ls_nu"].ravel(), ref["ls_gamma"].ravel()])
    np.testing.assert_allclose(x, xr, atol=1e-3 * np.abs(xr).max())
    np.testing.assert_allclose(s.run_batched(train=False)[1],
                               float(ref["ls_mse"]), rtol=1e-5)
    _, mse, npi, _ = s.run_batched_chunk(int(ref["mse"].shape[0]))
    np.testing.assert_allclose(mse, ref["mse"], rtol=RTOL)
    np.testing.assert_array_equal(npi, ref["num_pi"])
    np.testing.assert_array_equal(s.kernel_lists.numpy(), ref["lists"])
    rec = decode_bitstream(chip_smoke.LF_SMOE, device="cpu")
    st = int(ref["stride"])
    lsb = np.abs(np.round(rec[..., ::st, ::st, :] * 255)
                 - ref["sample"].astype(np.float64))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.999
    psnr = 10 * np.log10(1.0 / np.mean((rec - lf) ** 2))
    assert abs(psnr - float(ref["psnr_db"])) <= 0.01
