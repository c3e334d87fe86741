"""The 16-bit still path of the port against the JAX package: the DEM
fixture (tests/data/stills/dem16.tif, uint16, LZW with predictor 2) reads
alike in both packages at precision 16; on a 64^2 crop with 8 x 8 kernels
(influence cull 0.5 / 2^16) the port's CPU trainer steps 20 sweeps from
the JAX trainer's state within 1e-4 relative per sweep; the JAX CLI's
params give a byte-identical automatic encode (precision 16 in the .smoe
header); and cli.decode of that .smoe agrees within 1 LSB at 16 bits in
both packages, in the 16-bit PNG each writes.  ~25 s alone on one
worker."""

import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from smoe_tpu.io import images as jimg  # noqa: E402
from smoe_tpu_torch.io import images as timg  # noqa: E402
from tests.torch_still_writers import write_tiff  # noqa: E402

DEM16 = os.path.join(os.path.dirname(__file__), "data", "stills",
                     "dem16.tif")
STEP_RTOL = 1e-4


def test_dem16_reads_alike_at_precision_16():
    for use_yuv in (True, False):
        t, tp, _ = timg.read_image(DEM16, use_yuv)
        j, jp, _ = jimg.read_image(DEM16, use_yuv)
        assert tp == jp == 16 and t.shape == j.shape == (256, 256, 1)
        np.testing.assert_array_equal(t, j)
    raw = timg.read_still(DEM16)
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(raw, cv2.imread(DEM16,
                                                  cv2.IMREAD_UNCHANGED))


def crop():
    return timg.read_image(DEM16)[0][96:160, 96:160]


def test_precision16_sweeps_step_as_jax():
    """20 sweeps of the JAX trainer at precision 16, each also taken by
    the port's CPU trainer from the JAX trainer's state (params, lists,
    Adam moments): the sweep's mse within STEP_RTOL, num_pi and the
    in-graph lists equal."""
    from smoe_tpu.fit.trainer import Smoe as JSmoe
    from smoe_tpu_torch.fit.trainer import Smoe
    from test_torch_video import carry
    img = crop()
    kw = dict(kernels_per_dim=[8], use_determinant=True, precision=16,
              in_graph_ukl=True, use_yuv=False)
    js = JSmoe(img, **kw)
    js.set_optimizer()
    ts = Smoe(img, device="cpu", **kw)
    ts.set_optimizer()
    assert ts.cfg.precision == js.cfg.precision == 16
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mse = []
    try:
        for i in range(20):
            if i:
                carry(js, ts)
            _, tm, tn, _ = ts.run_batched_chunk(1)
            _, jm, jn, _ = js.run_batched_chunk(1)
            np.testing.assert_allclose(tm, np.asarray(jm), rtol=STEP_RTOL)
            np.testing.assert_array_equal(tn, np.asarray(jn))
            np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                          np.asarray(js.kernel_lists))
            mse.append(float(tm[0]))
    finally:
        torch.set_num_threads(n)
    assert np.isfinite(mse).all() and mse[-1] < mse[0]


def _run(main, args):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = main(args)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """The crop as a 16-bit LZW TIFF, a 200-sweep JAX CLI fit of it
    (`-k 8 -lsinit auto -lsri 100 -iukl 1`), and both packages' automatic
    encode of its params_best.pkl and decode of their model.smoe."""
    from smoe_tpu.cli import decode as jdec
    from smoe_tpu.cli import fit as jfit
    from smoe_tpu.cli import reconstruct as jrec
    from smoe_tpu_torch.cli import decode as tdec
    from smoe_tpu_torch.cli import reconstruct as trec
    root = tmp_path_factory.mktemp("p16")
    tif = str(root / "crop.tif")
    write_tiff(tif, timg.read_still(DEM16)[96:160, 96:160], compression=5,
               predictor=2, rows_per_strip=16)
    _run(jfit.main, ["-i", tif, "-r", str(root / "fit"), "-k", "8", "-n",
                     "200", "-lsinit", "auto", "-lsri", "100", "-iukl",
                     "1"])
    pkl = str(root / "fit" / "params_best.pkl")
    out = {"tif": tif}
    for pkg, rec, dec, dev in (("jax", jrec.main, jdec.main, []),
                               ("torch", trec.main, tdec.main,
                                ["--device", "cpu"])):
        e, d = str(root / f"{pkg}_enc"), str(root / f"{pkg}_dec")
        r, log = _run(rec, ["-i", tif, "-p", pkl, "-r", e] + dev)
        smoe = os.path.join(e, "model.smoe")
        dq, _ = _run(dec, ["-p", smoe, "-r", d] + dev)
        out[pkg] = {"rec": np.asarray(r), "log": log, "smoe": smoe,
                    "dec": np.asarray(dq), "png": os.path.join(d,
                                                               "output.png")}
    return out


def test_precision16_encode_is_byte_identical(encoded):
    from smoe_tpu_torch.codec.bitstream import read_header
    j, t = encoded["jax"], encoded["torch"]
    with open(j["smoe"], "rb") as a, open(t["smoe"], "rb") as b:
        assert a.read() == b.read()
    assert read_header(t["smoe"])["precision"] == 16
    np.testing.assert_allclose(t["rec"], j["rec"], rtol=0, atol=2 ** -16)


def test_precision16_decode_within_one_lsb(encoded):
    """cli.decode of one .smoe: each package's 16-bit PNG, each against
    the other and the port's against the encoder's reconstruction, whose
    gating sums in another order: at 16 bits ~0.2 % of values land on the
    other side of a rounding (at 8 bits ~1 in 10^4)."""
    j, t = encoded["jax"], encoded["torch"]
    pj = cv2.imread(j["png"], cv2.IMREAD_UNCHANGED)
    pt = timg.read_still(t["png"])
    assert pt.dtype == pj.dtype == np.uint16 and pt.shape == pj.shape
    assert np.abs(pt.astype(int) - pj.astype(int)).max() <= 1
    q = np.uint16(np.round(np.clip(t["rec"].reshape(pt.shape) * 2 ** 16, 0,
                                   65535)))
    off = np.abs(pt.astype(int) - q.astype(int))
    assert off.max() <= 1 and np.mean(off <= 1) >= 0.999
    assert np.mean(off == 0) >= 0.99
