"""PyTorch port: the encode CLI (cli/reconstruct.py with codec/alloc.py,
codec/prune.py, codec/container.py) and the pickle branch of cli/decode.py
against the JAX package's, on one toy fit written by the JAX package's
save_model.  Both run on the CPU (the port with --device cpu, its quantized
evals on the trainer's exact plain path).

The automatic encode's choices (depths, anchors, prune point) must be the
JAX package's, and every arm's model.smoe byte-identical: the quantizer
and the bitstream writer are numpy copies, so equal choices give equal
bytes."""

import contextlib
import io
import os
import pickle
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from smoe_tpu.cli import decode as jdec  # noqa: E402
from smoe_tpu.cli import reconstruct as jrec  # noqa: E402
from smoe_tpu_torch.cli import decode as tdec  # noqa: E402
from smoe_tpu_torch.cli import reconstruct as trec  # noqa: E402

ARMS = {
    "auto": [],
    "ref": ["--ref"],
    "bd": ["-bd", "12", "14", "8", "10", "8"],
    "lean": ["-lean", "1"],
    "layers": ["--prune", "0", "--layers", "2"],
}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A 32x32 RGB PNG and a 60-sweep, 4x4-kernel JAX fit of it, saved by
    the JAX package's save_model."""
    from smoe_tpu import Smoe
    from smoe_tpu.codec.container import save_model
    root = tmp_path_factory.mktemp("encode")
    img_path = str(root / "img.png")
    y, x = np.mgrid[0:32, 0:32] / 31.0
    img = np.stack([0.5 + 0.3 * np.sin(5 * x),
                    0.5 + 0.3 * np.cos(4 * y),
                    0.4 + 0.2 * np.sin(3 * (x + y))], -1)
    cv2.imwrite(img_path, np.uint8(img * 255))
    from smoe_tpu.io.images import read_image
    orig, _, _ = read_image(img_path)
    s = Smoe(orig, kernels_per_dim=[4])
    s.set_optimizer()
    s.run_batched_chunk(60)
    pkl = str(root / "params.pkl")
    save_model(pkl, s.get_params(), s.cfg)
    return img_path, pkl, root


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = main(args)
    return np.asarray(rec), buf.getvalue()


@pytest.fixture(scope="module")
def encoded(fitted):
    """Every arm through both packages' reconstruct: {(pkg, arm): (rec,
    stdout, out_dir)}."""
    img_path, pkl, root = fitted
    out = {}
    for arm, extra in ARMS.items():
        for pkg, main, dev in (("jax", jrec.main, []),
                               ("torch", trec.main, ["--device", "cpu"])):
            d = str(root / f"{pkg}_{arm}")
            rec, log = _run(main, ["-i", img_path, "-p", pkl, "-r", d]
                            + extra + dev)
            out[pkg, arm] = (rec, log, d)
    return out


def _choices(log):
    bd = re.search(r"auto-bd: (\[[^\]]*\]) nu_anchor=(\d) gamma_anchor=(\d)",
                   log)
    keep = re.search(r"prune: keeping (\d+)/(\d+) kernels", log)
    return (bd.groups() if bd else None, keep.groups() if keep else None)


def test_automatic_encode_chooses_as_jax(encoded):
    """Depths, anchors and prune point (ROADMAP Queue 1 item 2)."""
    j_log, t_log = encoded["jax", "auto"][1], encoded["torch", "auto"][1]
    assert "automatic encode (default)" in t_log
    j, t = _choices(j_log), _choices(t_log)
    assert j[0] is not None and j[1] is not None, j_log
    assert t == j, (t, j)
    # the PSNR of every candidate the searches measured, as printed (2 or
    # 3 decimals), to one unit of the last printed digit
    jp = [float(v) for v in re.findall(r"(\d+\.\d{2,3}) dB", j_log)]
    tp = [float(v) for v in re.findall(r"(\d+\.\d{2,3}) dB", t_log)]
    assert len(jp) == len(tp) and len(jp) > 10
    np.testing.assert_allclose(tp, jp, atol=1.01e-2)


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_smoe_is_byte_identical(encoded, arm):
    j_dir, t_dir = encoded["jax", arm][2], encoded["torch", arm][2]
    for name in ("model.smoe",):
        with open(os.path.join(j_dir, name), "rb") as a, \
                open(os.path.join(t_dir, name), "rb") as b:
            assert a.read() == b.read(), (arm, name)


@pytest.mark.parametrize("arm", list(ARMS))
def test_reconstruction_matches_jax(encoded, arm):
    """The encoder-side quantized reconstruction, to 1 output LSB (the two
    frameworks sum the gating in different orders)."""
    j, t = encoded["jax", arm][0], encoded["torch", arm][0]
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= 1.01 / 255


def test_prune_bpp_arm(fitted, encoded):
    """--prune-bpp: the same rate-controlled prefix and the same bytes."""
    img_path, pkl, root = fitted
    full_bits = int(re.search(r"rate: (\d+) bits coded",
                              encoded["jax", "ref"][1]).group(1))
    bpp = f"{0.5 * full_bits / (32 * 32):.6f}"
    files = {}
    for pkg, main, dev in (("jax", jrec.main, []),
                           ("torch", trec.main, ["--device", "cpu"])):
        d = str(root / f"{pkg}_bpp")
        _, log = _run(main, ["-i", img_path, "-p", pkl, "-r", d,
                             "--prune-bpp", bpp] + dev)
        files[pkg] = (open(os.path.join(d, "model.smoe"), "rb").read(),
                      re.search(r"prune: keeping (\d+)/(\d+)", log).groups())
    assert files["torch"][1] == files["jax"][1]
    assert int(files["torch"][1][0]) < int(files["torch"][1][1])
    assert files["torch"][0] == files["jax"][0]


def test_automatic_encode_beats_the_reference_depths(encoded, fitted):
    """As tests/test_cli.py:68-95 requires of the JAX package."""
    from smoe_tpu_torch.io.images import read_image
    orig, _, _ = read_image(fitted[0])
    arms = {}
    for name in ("auto", "ref"):
        rec, _, d = encoded["torch", name]
        mse = float(np.mean((rec.reshape(orig.shape) - orig) ** 2))
        arms[name] = (os.path.getsize(os.path.join(d, "model.smoe")),
                      10 * np.log10(1.0 / max(mse, 1e-12)))
    assert arms["auto"][0] < arms["ref"][0]
    assert arms["auto"][1] >= arms["ref"][1] - 0.3


@pytest.mark.parametrize("arm", ["auto", "layers"])
def test_pickle_and_bitstream_decode_match_reconstruction(encoded, tmp_path,
                                                          arm):
    """The port's pickle decode equals its reconstruction to 1e-6
    (tests/test_cli.py:46-65): both are the trainer's exact quantized
    eval.  Its .smoe decode runs the serving decoder, whose gating sums in
    another order: within 1 LSB, >= 99.9 % of values identical (the port's
    stated decode tolerance).  The JAX pickle decode of the port's
    qparams.pkl agrees to 1 LSB."""
    rec, _, d = encoded["torch", arm]
    dec_pkl, _ = _run(tdec.main, ["-p", os.path.join(d, "qparams.pkl"),
                                  "-r", str(tmp_path / "p"), "--device",
                                  "cpu"])
    np.testing.assert_allclose(dec_pkl, rec, atol=1e-6)
    dec_bs, _ = _run(tdec.main, ["-p", os.path.join(d, "model.smoe"),
                                 "-r", str(tmp_path / "b"), "--device",
                                 "cpu"])
    diff = np.abs(np.round(dec_bs * 255) - np.round(rec * 255))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    j_pkl, _ = _run(jdec.main, ["-p", os.path.join(d, "qparams.pkl"),
                                "-r", str(tmp_path / "j")])
    assert np.abs(j_pkl - dec_pkl).max() <= 1.01 / 255
    assert os.path.exists(str(tmp_path / "p" / "output.png"))


def test_pickle_decode_retries_only_on_out_of_memory(encoded, tmp_path,
                                                     monkeypatch):
    from smoe_tpu_torch.fit import trainer
    d = encoded["torch", "ref"][2]
    args = ["-p", os.path.join(d, "qparams.pkl"), "-r", str(tmp_path),
            "--device", "cpu"]
    real = trainer.Smoe.run_batched
    calls = []

    def oom_once(self, *a, **kw):
        calls.append(self.start_batches)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("test: out of memory")
        return real(self, *a, **kw)

    monkeypatch.setattr(trainer.Smoe, "run_batched", oom_once)
    rec, log = _run(tdec.main, args)
    assert "retrying with 2 blocks" in log
    assert calls[0] < calls[1] and rec.shape == (32, 32, 3)

    def fault(self, *a, **kw):
        raise RuntimeError("test: not a memory fault")

    monkeypatch.setattr(trainer.Smoe, "run_batched", fault)
    with pytest.raises(RuntimeError, match="not a memory fault"):
        _run(tdec.main, args)


def test_clis_refuse_cuda_without_a_gpu(fitted, encoded, tmp_path,
                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img_path, pkl, _ = fitted
    with pytest.raises(SystemExit, match="no CUDA device"):
        trec.main(["-i", img_path, "-p", pkl, "-r", str(tmp_path)])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tdec.main(["-p", os.path.join(encoded["torch", "ref"][2],
                                      "qparams.pkl"), "-r", str(tmp_path)])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_save_model_round_trips_between_packages(fitted, tmp_path, writer,
                                                 reader):
    """A pickle that one package's save_model writes loads in the other's
    load_model / load_params, and equals the other's own pickle."""
    import importlib
    from smoe_tpu.config import SmoeConfig as JConfig
    from smoe_tpu_torch.config import SmoeConfig as TConfig
    pkg = {"jax": ("smoe_tpu.codec.container", JConfig),
           "torch": ("smoe_tpu_torch.codec.container", TConfig)}
    with open(fitted[1], "rb") as fd:
        params = {k: np.array(v) for k, v in pickle.load(fd)["params"].items()}
    params["pis"][3] = 0.0                           # one dead kernel
    used = params["pis"] > 0
    grid = np.random.default_rng(0).uniform(0, 1, (16, 2)).astype(
        np.float32)
    loaded = {}
    for name in (writer, reader):
        mod = importlib.import_module(pkg[name][0])
        cfg = pkg[name][1](kernels_per_dim=(4, 4), use_diff_center=True)
        path = str(tmp_path / f"{name}.pkl")
        mod.save_model(path, params, cfg, qparams={"pis": np.arange(15)},
                       losses=[(0, 1.0)], musX_grid=grid)
        r = importlib.import_module(pkg[reader][0])
        loaded[name] = r.load_model(path)
        assert r.load_params(path).keys() == loaded[name]["params"].keys()
    cp = loaded[writer]
    for k, v in cp["params"].items():
        np.testing.assert_array_equal(v, params[k][used])
    np.testing.assert_array_equal(cp["musX_grid"], grid[used])
    np.testing.assert_array_equal(cp["qparams"]["used_kernels"], used)
    assert cp["losses"] == [(0, 1.0)] and cp["kernels_per_dim"] == [4, 4]
    mine = loaded[reader]
    assert cp.keys() == mine.keys()
    assert cp["qparams"].keys() == mine["qparams"].keys()
    for k, v in cp.items():
        if k not in ("params", "qparams", "musX_grid"):
            assert v == mine[k], k


@pytest.mark.parametrize("n_pix,k_cap,user", [
    (256 * 256, 144, 1), (288 * 352 * 8, 8192, 1), (64, 4, 8),
    (512 * 512, 256, 1), (512 * 512, 16384, 1), (1920 * 1080, 576, 1),
    (3840 * 2160, 2304, 1), (3840 * 2160, 2304, 64), (1, 1, 1),
    (811008, 8192, 3)])
def test_estimate_batches_matches_jax(n_pix, k_cap, user):
    assert trec.estimate_batches(n_pix, k_cap, user) == \
        jrec.estimate_batches(n_pix, k_cap, user)
