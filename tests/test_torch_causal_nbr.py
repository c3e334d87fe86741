"""The bitstream's "nbr" mode on the port's native search
(smoe_tpu_torch/codec/csrc/causal_nbr.cc): `causal_nbr` returns exactly
the indices of the loop `_causal_nbr`, and `nbr_decode` exactly the output
of the loop `_nbr_decode`, on grids, ties, duplicates, clusters, the
smallest K and negative integers; wider inputs and a missing compiler take
the loops; a 4K-shaped file reads to the same params either way and stays
byte-identical to the JAX package's."""

import shutil
import subprocess

import numpy as np
import pytest

import torch_cpu  # noqa: F401

from smoe_tpu.codec import bitstream as jbs
from smoe_tpu.config import SmoeConfig as JConfig
from smoe_tpu_torch.codec import bitstream as bs
from smoe_tpu_torch.codec import serve
from smoe_tpu_torch.codec.quantize import quantize_params
from smoe_tpu_torch.config import SmoeConfig


def _grid(g, d, step):
    axes = [np.arange(g, dtype=np.int64) * step] * d
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, d)


def _jittered(g, d, seed=0):
    rng = np.random.default_rng(seed)
    pts = _grid(g, d, 45)
    return pts + rng.integers(-6, 7, pts.shape)


def _culled(seed=1):
    """A 48 x 48 jittered grid with a third of its kernels pruned."""
    rng = np.random.default_rng(seed)
    pts = _jittered(48, 2, seed)
    return pts[rng.random(len(pts)) > 1 / 3]


def _duplicates(seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 200, (20, 2))[rng.integers(0, 20, 600)]


def _one_cell():
    """A cluster of 400 kernels that the grid's cells cannot separate, and
    two far away: the search degenerates to a scan of one cell."""
    rng = np.random.default_rng(3)
    far = np.array([[10 ** 6, 10 ** 6], [-10 ** 6, 3]])
    return np.concatenate([rng.integers(0, 4, (200, 2)), far,
                           rng.integers(0, 4, (200, 2))])


CASES = {
    "jittered_d2_k2304": lambda: _jittered(48, 2),
    "jittered_d3": lambda: _jittered(13, 3),
    "jittered_d4": lambda: _jittered(7, 4),
    "exact_grid_d2_k2304": lambda: _grid(48, 2, 100),
    "exact_grid_d3": lambda: _grid(10, 3, 7),
    "culled_grid": _culled,
    "duplicates": _duplicates,
    "all_one_position": lambda: np.full((300, 3), 17, np.int64),
    "one_cell": _one_cell,
    "k0": lambda: np.zeros((0, 2), np.int64),
    "k1": lambda: np.array([[5, -3]]),
    "k2": lambda: np.array([[5, -3], [-7, 9]]),
    "uniform_d2": lambda: np.random.default_rng(4).integers(
        0, 10 ** 4, (2000, 2)),
    "uniform_d3": lambda: np.random.default_rng(5).integers(
        0, 10 ** 4, (1500, 3)),
    "line_d1": lambda: np.random.default_rng(6).integers(-50, 50, (400, 1)),
    # a `ranges`-shifted stream decodes to signed integers
    "negative": lambda: np.random.default_rng(7).integers(
        -(1 << 20), 1 << 20, (1000, 2)),
    "span_just_under_2_30": lambda: np.concatenate(
        [np.random.default_rng(8).integers(-(1 << 29), 1 << 29, (500, 4)),
         np.array([[-(1 << 29)] * 4, [(1 << 29) - 1] * 4])]),
}


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native neighbour search")
    lib = bs._load_nbr()
    assert lib is not None
    return lib


def _refuse(*_):
    raise AssertionError("took the loop")


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_equals_the_loop(case, native, monkeypatch):
    m = CASES[case]()
    want = bs._causal_nbr(m)
    monkeypatch.setattr(bs, "_causal_nbr", _refuse)
    if len(m) <= 1:         # nothing to search: the loop's answer
        monkeypatch.undo()
    got = bs.causal_nbr(m)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "k0"))
def test_inversion_equals_the_loop(case, native, monkeypatch):
    m = CASES[case]()
    k = len(m)
    nbr = bs._causal_nbr(m)
    z = np.random.default_rng(k).integers(0, 1 << 32, 3 * k,
                                          dtype=np.uint64).astype(np.uint32)
    want = bs._nbr_decode(z, k, nbr)
    monkeypatch.setattr(bs, "_nbr_decode", _refuse)
    got = bs.nbr_decode(z, k, nbr)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_inversion_of_no_kernels_raises_as_the_loop():
    z = np.zeros(0, np.uint32)
    nbr = np.zeros(0, np.int64)
    with pytest.raises(ValueError):
        bs._nbr_decode(z, 0, nbr)
    with pytest.raises(ValueError):
        bs.nbr_decode(z, 0, nbr)


@pytest.mark.parametrize("m", [
    np.array([[0, 0], [1 << 30, 0], [5, 7], [1 << 29, 3]]),
    np.array([[-(1 << 40), 2], [1 << 40, -2], [0, 0], [7, 1]]),
    np.random.default_rng(9).integers(0, 100, (50, 5)),
], ids=["span_2_30", "span_2_41", "d5"])
def test_wide_or_deep_inputs_take_the_loop(m, monkeypatch):
    """Every axis must span under 2^30 (the loop's int64 sums can then not
    overflow) and d must be 1-4; else the native search is not asked."""
    want = bs._causal_nbr(m)
    monkeypatch.setattr(bs, "_load_nbr", _refuse)
    np.testing.assert_array_equal(bs.causal_nbr(m), want)


def test_forward_pointing_neighbours_take_the_loop(native, monkeypatch):
    """The recurrence runs natively only where each row's neighbour is an
    earlier row, as every graph of `causal_nbr` is."""
    z = np.arange(12, dtype=np.uint32)
    nbr = np.array([0, 0, 3, 1])
    want = bs._nbr_decode(z, 4, nbr)
    calls = []
    monkeypatch.setattr(bs, "_nbr_decode",
                        lambda *a: calls.append(a) or want)
    np.testing.assert_array_equal(bs.nbr_decode(z, 4, nbr), want)
    assert len(calls) == 1


def test_no_library_takes_the_loops(monkeypatch):
    m = _jittered(12, 2)
    nbr = bs._causal_nbr(m)
    z = np.arange(len(m) * 2, dtype=np.uint32)
    monkeypatch.setattr(bs, "_load_nbr", lambda: None)
    np.testing.assert_array_equal(bs.causal_nbr(m), nbr)
    np.testing.assert_array_equal(bs.nbr_decode(z, len(m), nbr),
                                  bs._nbr_decode(z, len(m), nbr))


def test_missing_compiler_builds_nothing(tmp_path, monkeypatch):
    src = tmp_path / "causal_nbr.cc"
    src.write_text("int x;\n")
    so = tmp_path / "build" / "libx.so"

    def no_gxx(*_, **__):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", no_gxx)
    assert bs._shared_library(str(src), str(so)) is None
    assert not so.exists()
    assert list((tmp_path / "build").iterdir()) == []


# --- a 4K-shaped pool file, as the serving benchmark writes it -------------

H, W, KPD = 2160, 3840, 48
BIT_DEPTHS = (20, 18, 6, 10, 10)
EXTRA = {"shape_of_img": [H, W], "dim_of_output": 3, "use_yuv": True,
         "use_determinant": True, "train_gammas": True}


def _params4k(jitter, seed=0):
    """The grid initialisation of a smooth 4K still (musX jittered off the
    grid where `jitter`, as after training), its correlations and slopes
    drawn from the seed."""
    rng = np.random.default_rng(seed)
    axis = np.linspace(0.5 / KPD, 1.0 - 0.5 / KPD, KPD)
    mus = np.stack(np.meshgrid(axis, axis, indexing="ij"), -1).reshape(-1, 2)
    if jitter:
        mus = mus + rng.normal(0, 0.2 / KPD, mus.shape)
    k = len(mus)
    y, x = mus[:, 0:1], mus[:, 1:2]
    nu = np.concatenate([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                         0.5 + 0.25 * np.cos(3 * x * y),
                         0.4 + 0.3 * np.sin(5 * x * y)], 1)
    a = 2.0 * (KPD + 1)
    diag = np.tile(np.diag([a, a])[None], (k, 1, 1))
    corr = np.tril(rng.normal(0, 10.0, (k, 2, 2)), -1)
    return {"pis": np.full(k, 1.0 / k), "musX": mus, "A_diagonal": diag,
            "A_corr": corr, "nu_e": nu,
            "gamma_e": rng.normal(0, 0.1, (k, 2, 3))}


@pytest.mark.parametrize("jitter", [False, True], ids=["grid", "trained"])
def test_4k_file_reads_the_same_params_either_way(jitter, tmp_path,
                                                  monkeypatch, native):
    params = {n: np.asarray(v, np.float32)
              for n, v in _params4k(jitter).items()}
    cfg = SmoeConfig(kernels_per_dim=(KPD, KPD), use_yuv=True,
                     use_determinant=True, precision=8,
                     bit_depths=BIT_DEPTHS)
    jcfg = JConfig(kernels_per_dim=(KPD, KPD), use_yuv=True,
                   use_determinant=True, precision=8, bit_depths=BIT_DEPTHS)
    qp = quantize_params(params, cfg)
    fast, slow, ref = (str(tmp_path / f"{n}.smoe")
                       for n in ("fast", "slow", "jax"))
    bs.write_bitstream(fast, qp, cfg, extra=EXTRA)
    jbs.write_bitstream(ref, qp, jcfg, extra=EXTRA)
    got = serve.read_model(fast)
    with monkeypatch.context() as mp:
        mp.setattr(bs, "_load_nbr", lambda: None)     # the loops alone
        bs.write_bitstream(slow, qp, cfg, extra=EXTRA)
        want = serve.read_model(slow)
    with open(fast, "rb") as f1, open(slow, "rb") as f2, \
            open(ref, "rb") as f3:
        b1, b2, b3 = f1.read(), f2.read(), f3.read()
    assert b1 == b2 == b3
    header = bs.read_header(fast)
    assert header["num_kernels"] == KPD * KPD
    assert "nbr" in header["modes"].values()
    assert got[0] == want[0] and got[2] == want[2]
    assert sorted(got[1]) == sorted(want[1])
    for name in want[1]:
        a, b = np.asarray(got[1][name]), np.asarray(want[1][name])
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
