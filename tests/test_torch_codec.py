"""PyTorch port: the codec copies (smoe_tpu_torch/codec/quantize.py,
bitstream.py) against the JAX package's.  The copies keep the numpy op
order, so quantized integers, dequantized values and `.smoe` bytes must be
identical, not merely close."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from smoe_tpu.codec import bitstream as jbs  # noqa: E402
from smoe_tpu.codec import quantize as jq  # noqa: E402
from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core.init import init_params  # noqa: E402
from smoe_tpu_torch.codec import bitstream as tbs  # noqa: E402
from smoe_tpu_torch.codec import quantize as tq  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402

VARIANTS = {
    "default": {},
    "radial": {"radial_as": True},
    "inverse_cov": {"train_inverse_cov": True},
    "anchored_qpis": {"nu_anchor": True, "gamma_anchor": True,
                      "quantize_pis": True},
    "qat_fixed_bounds": {"quantization_mode": 2},
    "diff_center": {"use_diff_center": True},
    "gray_const_experts": {"num_channels": 1, "use_yuv": False,
                           "train_gammas": False},
}


def _model(variant, seed=0):
    """A Smoe.get_params()-style dict from the JAX init, perturbed so
    correlations and slopes are non-trivial, with some dead kernels."""
    kw = VARIANTS[variant]
    c = kw.get("num_channels", 3)
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.9, (20, 24, c)).astype(np.float32)
    jcfg = JConfig(kernels_per_dim=(4, 5), **kw)
    tcfg = SmoeConfig(kernels_per_dim=(4, 5), **kw)
    p = init_params(img, jcfg)
    pis = np.asarray(p.pis) * rng.uniform(0.5, 1.5, p.pis.shape)
    pis[[2, 9, 13]] = 0.0
    a_diag = np.asarray(p.a_diag) * rng.uniform(0.7, 1.3,
                                                np.shape(p.a_diag))
    if not jcfg.radial_as:
        a_diag[3, 1, 1] *= -1.0            # exercises canonicalize_steering
    params = {
        "pis": pis.astype(np.float32),
        "musX": (np.asarray(p.musX) + rng.normal(0, 0.02, p.musX.shape)
                 ).astype(np.float32),
        "A_diagonal": a_diag.astype(np.float32),
        "A_corr": np.tril(rng.normal(0, 3.0, p.a_corr.shape), -1
                          ).astype(np.float32),
        "nu_e": np.asarray(p.nu_e),
        "gamma_e": rng.normal(0, 0.2, p.gamma_e.shape).astype(np.float32),
    }
    return jcfg, tcfg, params


def _assert_same(a, b, path="qparams"):
    """Deep equality of the codec's nested dicts: same keys, same array
    values and dtypes, same scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_quantize_and_rescaler_identical(variant):
    jcfg, tcfg, params = _model(variant)
    qp_j = jq.quantize_params(params, jcfg)
    qp_t = tq.quantize_params(params, tcfg)
    _assert_same(qp_t, qp_j)
    grid_j, grid_t = jbs._grid_of_used(qp_j, jcfg), tbs._grid_of_used(qp_t,
                                                                      tcfg)
    assert (grid_j is None) == (not jcfg.use_diff_center)
    _assert_same(grid_t, grid_j)
    _assert_same(tq.rescaler(qp_t, tcfg, musX_grid=grid_t),
                 jq.rescaler(qp_j, jcfg, musX_grid=grid_j))
    assert tq.rate_bits(qp_t, tcfg) == jq.rate_bits(qp_j, jcfg)
    keep = np.arange(qp_j["pis"].shape[0]) % 3 != 1
    _assert_same(tq.subset_qparams(qp_t, keep), jq.subset_qparams(qp_j,
                                                                   keep))


def _extra(cfg):
    return {"shape_of_img": [20, 24], "dim_of_output": [cfg.num_channels],
            "use_yuv": bool(cfg.use_yuv),
            "use_determinant": bool(cfg.use_determinant)}


@pytest.mark.parametrize("layers", [None, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_write_bitstream_byte_identical(variant, layers, tmp_path):
    jcfg, tcfg, params = _model(variant, seed=1)
    qp = jq.quantize_params(params, jcfg)
    pj, pt = str(tmp_path / "jax.smoe"), str(tmp_path / "torch.smoe")
    bits_j = jbs.write_bitstream(pj, qp, jcfg, extra=_extra(jcfg),
                                 layers=layers)
    bits_t = tbs.write_bitstream(pt, qp, tcfg, extra=_extra(tcfg),
                                 layers=layers)
    assert bits_t == bits_j > 0
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert ft.read() == fj.read()


@pytest.mark.parametrize("variant", ["default", "diff_center"])
def test_read_bitstream_roundtrip(variant, tmp_path):
    """The port reads what either package writes back to the quantized
    integers, flat and layered, and agrees with the JAX reader on every
    tier prefix and byte budget."""
    jcfg, tcfg, params = _model(variant, seed=2)
    qp = tq.quantize_params(params, tcfg)
    flat, lay = str(tmp_path / "flat.smoe"), str(tmp_path / "lay.smoe")
    tbs.write_bitstream(flat, qp, tcfg, extra=_extra(tcfg))
    tbs.write_bitstream(lay, qp, tcfg, extra=_extra(tcfg), layers=3)

    back, header = tbs.read_bitstream(flat)
    for name in ("A_diagonal", "A_corr", "musX", "nu_e", "pis", "gamma_e",
                 "used_kernels"):
        np.testing.assert_array_equal(np.asarray(back[name]),
                                      np.asarray(qp[name]), err_msg=name)
    assert header["shape_of_img"] == [20, 24]
    _assert_same(tbs.read_bitstream(flat), jbs.read_bitstream(flat))
    _assert_same(tbs.read_header(lay), jbs.read_header(lay))
    for m in (1, 2, 3):
        _assert_same(tbs.read_bitstream(lay, max_layers=m),
                     jbs.read_bitstream(lay, max_layers=m))
    full = tbs.read_bitstream(lay)[0]
    assert int(np.count_nonzero(full["used_kernels"])) == \
        int(np.count_nonzero(qp["used_kernels"]))
    per = [int(lh["bytes"]) for lh in tbs.read_header(lay)["layers"]]
    size = os.path.getsize(lay)
    for budget in (size, size - per[-1], size - per[-1] - per[-2]):
        assert tbs.layers_for_budget(lay, budget) == \
            jbs.layers_for_budget(lay, budget)
