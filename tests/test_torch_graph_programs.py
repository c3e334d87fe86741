"""PyTorch port: the JAX package's compiled programs other than the
training chunk as programs of the port (smoe_tpu_torch/fit/graph.py:
Programs): the trainer's eval sweeps (light, with the reconstruction,
quantized), the LS refresh's accumulation, solves and line search, the
serving decoder and the mesh sweep's backend rule, on the CPU.

On the CPU every program runs eagerly; the `replaying` fixture stands in
CUDA graphs that record their function and run it at each replay, so the
graphed path's control flow (the first call of a key eager, the second
captured and replayed, later ones replayed; inputs copied into buffers,
outputs read from buffers) runs here.  Whether a replay on the card reads
the params of the call, not an earlier call's, is held on the card
(chip_smoke.py phase 24); here the keys and buffers that make it so are.

Tolerances: the evals against the JAX package's `run_batched(train=False)`
from the same params and lists, loss and mse within 1e-5 relative, the
survivors identical, the reconstruction within 1e-6; the sync-free solves
at tests/test_torch_lsinit.py's tolerances (1e-4 of max |x|).
"""

import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from smoe_tpu.codec.quantize import quantize_params as jq  # noqa: E402
from smoe_tpu.codec.quantize import rescaler as jr  # noqa: E402
from smoe_tpu.fit import lsinit as jls  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu_torch.codec import serve  # noqa: E402
from smoe_tpu_torch.fit import graph  # noqa: E402
from smoe_tpu_torch.fit import lsinit as tls  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402

from test_torch_lsinit import X_TOL, _close, _gram  # noqa: E402

EVAL_RTOL = 1e-5
REC_TOL = 1e-6
KW = dict(kernels_per_dim=[8], batch_size=(16, 16), quantization_mode=1)


def _toy(n=32):
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    return np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                     0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                     0.4 + 0.3 * np.sin(5 * x * y)], -1).astype(np.float32)


class ReplayingGraph:
    """A SweepGraph stand-in for the CPU: the capture records fn without
    running it, each replay runs it."""

    made = []

    def __init__(self, fn, pool=None, generators=()):
        self.fn, self.capture_s, self.replays = fn, 0.0, 0
        ReplayingGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def replaying(monkeypatch):
    """The graphed path's control flow on the CPU, for the trainer's
    programs and the decoder's."""
    ReplayingGraph.made = []
    for mod in (ttr, serve):
        monkeypatch.setattr(mod, "graphed",
                            lambda device: not graph._EAGER[0])
    for mod in (ttr, graph):
        monkeypatch.setattr(mod, "warm_up", lambda fn: fn())
        monkeypatch.setattr(mod, "SweepGraph", ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return ReplayingGraph.made


EVALS = {"light": {}, "rec": {"update_reconstruction": True},
         "quantized": {"update_reconstruction": True,
                       "with_quantized_params": True}}


@pytest.fixture(scope="module")
def jax_evals():
    """A JAX trainer after 5 sweeps (its params and lists) and each kind
    of its eval from them: {kind: (run_batched's result, lists after,
    reconstruction, argmax)}."""
    js = JSmoe(_toy(), **KW)
    js.set_optimizer()
    js.run_batched_chunk(5)
    params, lists = js.params.to_numpy(), np.array(js.kernel_lists)
    js.qparams = jq(js.get_params(), js.cfg)
    js.rparams = jr(js.qparams, js.cfg)
    out = {}
    for kind, kw in EVALS.items():
        js.kernel_lists = jnp.asarray(lists)
        res = js.run_batched(train=False, **kw)
        q = "with_quantized_params" in kw
        out[kind] = (res, np.array(js.kernel_lists),
                     np.asarray(js.get_qreconstruction() if q
                                else js.get_reconstruction()),
                     np.asarray(js.qweight_matrix_argmax if q
                                else js.weight_matrix_argmax))
    return params, lists, out


def _port(params, lists):
    """A port trainer holding the given params and lists."""
    ts = Smoe(_toy(), device="cpu", **KW)
    ts.set_params(params)
    ts.kernel_lists = torch.as_tensor(lists)
    return ts


@pytest.mark.parametrize("path", ["eager", "graphed"])
@pytest.mark.parametrize("kind", sorted(EVALS))
def test_buffered_eval_matches_jax(request, jax_evals, kind, path):
    """Three evals in a row (on the graphed path: eager, captured and
    replayed, replayed) against the JAX package's eval of the same
    params."""
    if path == "graphed":
        request.getfixturevalue("replaying")
    kw = EVALS[kind]
    params, lists, jax_out = jax_evals
    jout, jlists, jrec, jarg = jax_out[kind]
    ts = _port(params, lists)
    if "with_quantized_params" in kw:
        ts._quantize_now()
    lists0 = ts.kernel_lists.clone()
    for _ in range(3):
        ts.kernel_lists = lists0.clone()
        tout = ts.run_batched(train=False, **kw)
        np.testing.assert_allclose(tout[:2], jout[:2], rtol=EVAL_RTOL)
        assert tout[2:] == jout[2:]
        np.testing.assert_array_equal(ts.kernel_lists.numpy(), jlists)
        if "update_reconstruction" in kw:
            q = "with_quantized_params" in kw
            trec = ts.get_qreconstruction() if q else ts.get_reconstruction()
            np.testing.assert_allclose(trec, jrec, rtol=0, atol=REC_TOL)
            np.testing.assert_array_equal(
                ts.qweight_matrix_argmax if q else ts.weight_matrix_argmax,
                jarg)
    if path == "graphed":
        assert len(ts._programs.graphs) == 1


def _trained():
    """A port trainer after 5 sweeps."""
    ts = Smoe(_toy(), device="cpu", **KW)
    ts.run_batched_chunk(5)
    return ts


def _graph_key_count(s):
    return len(s._programs.graphs), len(s._programs.buffers)


def test_quantized_evals_reuse_their_buffers_and_read_each_model(replaying):
    """Two quantizations in a row scatter into the same buffers (equal
    data_ptr), so the second eval replays the first's program (no new
    key), and reads the second model: its mse is a fresh trainer's eval
    of that model, not the first's."""
    ts = _trained()
    ts._quantize_now()
    first = ts.run_batched(train=False, with_quantized_params=True)
    ptrs = [b.data_ptr() for b in ts._qeff]
    ts.run_batched_chunk(3)
    ts._quantize_now()
    second = ts.run_batched(train=False, with_quantized_params=True)
    assert [b.data_ptr() for b in ts._qeff] == ptrs
    assert _graph_key_count(ts) == (1, 1)
    third = ts.run_batched(train=False, with_quantized_params=True)
    assert third == second != first
    fresh = Smoe(_toy(), device="cpu", **KW)
    fresh.set_params(ts.get_params())
    fresh.kernel_lists = ts.kernel_lists.clone()
    fresh.qparams, fresh.rparams = ts.qparams, ts.rparams
    assert fresh.run_batched(train=False, with_quantized_params=True) \
        == second


def test_light_eval_reads_the_lists_of_the_call(replaying):
    """The lists go through the sweep's lists buffer: a replayed eval
    reads the lists set after the capture."""
    ts = _trained()
    lists0 = ts.kernel_lists.clone()
    for _ in range(2):
        ts.kernel_lists = lists0.clone()
        a = ts.run_batched(train=False)
    one = torch.zeros_like(lists0)
    one[:, :8] = True
    ts.kernel_lists = one
    b = ts.run_batched(train=False)
    fresh = Smoe(_toy(), device="cpu", **KW)
    fresh.set_params(ts.get_params())
    fresh.kernel_lists = one.clone()
    assert b == fresh.run_batched(train=False) != a
    assert _graph_key_count(ts) == (1, 1)


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("damp", [0.0, 1e-2])
def test_sync_free_solves_match_jax(coupled, damp):
    """The solves with their failures collected (the refresh's path):
    JAX's solve within X_TOL, and no system failed."""
    from smoe_tpu.config import SmoeConfig as JConfig
    from smoe_tpu_torch.config import SmoeConfig
    G, b, nu0, gam0 = _gram(coupled)
    jsolve = jls._solve_coupled if coupled else jls._solve_kernel
    tsolve = tls._solve_coupled if coupled else tls._solve_kernel
    jnu, jgam = jsolve(*map(jnp.asarray, (G, b, nu0, gam0)), JConfig(),
                       1e-6, damp)
    failures = []
    tnu, tgam = tsolve(*map(torch.as_tensor, (G, b, nu0, gam0)),
                       SmoeConfig(), 1e-6, damp, failures)
    _close(tnu.numpy(), jnu, X_TOL, "nu")
    _close(tgam.numpy(), jgam, X_TOL, "gamma")
    assert failures and all(float(f[0]) == -1.0 for f in failures)
    tls.raise_failed_solves(torch.cat(failures).tolist())


def test_singular_systems_raise_as_torch_linalg_solve():
    """A singular per-kernel system raises where torch.linalg.solve
    would, with its message; collected, at the check after the pull."""
    from smoe_tpu_torch.config import SmoeConfig
    G, b, nu0, gam0 = map(torch.as_tensor, _gram(False))
    G[2] = -1e-6 * torch.eye(G.shape[1])        # G + the 1e-6 ridge = 0
    with pytest.raises(torch.linalg.LinAlgError) as want:
        torch.linalg.solve(G + 1e-6 * torch.eye(G.shape[1]), b)
    with pytest.raises(torch.linalg.LinAlgError) as got:
        tls._solve_kernel(G, b, nu0, gam0, SmoeConfig(), 0.0, 0.0)
    assert str(got.value) == str(want.value)
    assert "(Batch element 2)" in str(got.value)
    failures = []
    tls._solve_kernel(G, b, nu0, gam0, SmoeConfig(), 0.0, 0.0, failures)
    with pytest.raises(torch.linalg.LinAlgError, match=str(
            want.value).replace("(", r"\(").replace(")", r"\)")):
        tls.raise_failed_solves(torch.cat(failures).tolist())
    with pytest.raises(torch.linalg.LinAlgError) as one:
        tls._solve(torch.zeros((3, 3)), torch.ones((3, 1)), None)
    assert str(one.value) == ("torch.linalg.solve: The solver failed "
                              "because the input matrix is singular.")


@pytest.mark.parametrize("mode,damp", [("kernel", 0.0), ("coupled", 0.0),
                                       ("kernel", 1e-2)])
def test_ls_refresh_programs_equal_the_eager_refresh(replaying, mode, damp):
    """Three refreshes with sweeps between them, through the programs and
    eagerly on a trainer made alike: params bit-identical after each, the
    same gated mass; one program a piece of the refresh, replayed."""
    a, b = (Smoe(_toy(), device="cpu", **KW) for _ in range(2))
    for s in (a, b):
        s.set_optimizer()
    for _ in range(3):
        ma = a.ls_init_experts(mode=mode, damp=damp)
        with ttr.eager():
            mb = b.ls_init_experts(mode=mode, damp=damp)
        assert ma == mb
        for f in ("nu_e", "gamma_e"):
            assert torch.equal(getattr(a.params, f), getattr(b.params, f))
        for s in (a, b):
            with ttr.eager():
                s.run_batched_chunk(2)
    pieces = 2 if mode == "coupled" else 3
    assert len(a._programs.graphs) == pieces
    assert len(b._programs.graphs) == 0


def test_ls_refresh_raises_before_writing(monkeypatch):
    """A failed solve raises after the pull and leaves the experts as
    they were."""
    s = Smoe(_toy(), device="cpu", **KW)
    before = s.params.nu_e.detach().clone()
    real = torch.linalg.solve_ex

    def failing(A, B):
        x, info = real(A, B)
        return x * float("nan"), torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "solve_ex", failing)
    with pytest.raises(torch.linalg.LinAlgError, match="Batch element 0"):
        s.ls_init_experts(mode="kernel")
    assert torch.equal(s.params.nu_e, before)


def _decoder_params(seed):
    from smoe_tpu_torch.codec.serve import pad_decoded_params
    rng = np.random.default_rng(seed)
    k = 16
    A = np.zeros((k, 2, 2), np.float32)
    A[:, 0, 0] = A[:, 1, 1] = rng.uniform(6, 10, k)
    g = (np.arange(4) + 0.5) / 4
    musX = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(k, 2)
    rp = {"A": A, "musX": musX.astype(np.float32),
          "nu_e": rng.uniform(0.2, 0.8, (k, 3)).astype(np.float32),
          "gamma_e": rng.normal(0, 0.1, (k, 2, 3)).astype(np.float32),
          "pis": np.full((k,), 1.0 / k, np.float32)}
    p = pad_decoded_params(rp, k, 2, 3)
    return [p[n] for n in ("A", "musX", "nu_e", "gamma_e", "pis")]


def test_decoder_reads_the_params_of_each_call(replaying):
    """A decoder called with params A, then B, then A returns A's, B's and
    A's decode (an eager decoder's), through one program and the same
    parameter buffers."""
    from smoe_tpu_torch.config import SmoeConfig
    cfg = SmoeConfig(dim_domain=2, num_channels=3, kernels_per_dim=(4, 4))
    dec = serve.make_decoder((24, 24), 3, cfg, 16, device="cpu")
    plain = serve.make_decoder((24, 24), 3, cfg, 16, device="cpu")
    pa, pb = _decoder_params(0), _decoder_params(1)
    with ttr.eager():
        want = {id(pa): plain(*pa), id(pb): plain(*pb)}
    assert not torch.equal(want[id(pa)], want[id(pb)])
    outs = [dec(*p) for p in (pa, pb, pa)]
    for out, p in zip(outs, (pa, pb, pa)):
        assert torch.equal(out, want[id(p)])
    assert len(dec.programs.graphs) == 1 and len(replaying) == 1
    # the caller's result is its own: a later call does not overwrite it
    assert torch.equal(outs[0], want[id(pa)])
    assert len(plain.programs.graphs) == 0
    # a one-shot decoder (decode_bitstream's) never captures
    once = serve.make_decoder((24, 24), 3, cfg, 16, device="cpu")
    assert torch.equal(once(*pb), want[id(pb)])
    assert not once.programs.graphs


def test_mesh_sweep_is_captured_by_its_backend(monkeypatch, tmp_path):
    """A gloo mesh sweeps eagerly and an NCCL one captures, decided by the
    groups' backend, which the sweep's key holds."""
    import torch.distributed as dist
    from smoe_tpu_torch.parallel.sharded import make_mesh
    monkeypatch.setattr(ttr, "graphed", lambda device: True)
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        s = Smoe(_toy(16), kernels_per_dim=[4], device="cpu",
                 mesh=make_mesh(1, 1, "cpu"))
        key = s._mesh_key()
        assert [b for _, b in key[1]] == ["gloo"] and key[0] == (0, 1, 0,
                                                                 16)
        assert not s._sweep_captured()
        monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
        assert s._sweep_captured() and s._mesh_key() != key
        # evals and the LS refresh stay eager under any mesh
        assert s._program(("k",), lambda: ("eager",)) == ("eager",)
    finally:
        dist.destroy_process_group()
    assert Smoe(_toy(16), kernels_per_dim=[4], device="cpu")._mesh_key() \
        is None


def _reconstruct(img_path, pkl, out):
    from smoe_tpu_torch.cli import reconstruct
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        reconstruct.main(["-i", img_path, "-p", pkl, "-r", out,
                          "--device", "cpu"])
    with open(os.path.join(out, "model.smoe"), "rb") as f:
        return f.read(), buf.getvalue()


def test_encode_through_programs_writes_the_eager_bytes(tmp_path,
                                                         monkeypatch):
    """The automatic encode (cli.reconstruct) with its quantized evals
    through the programs: the same choices and a byte-identical
    model.smoe as the eager encode."""
    from smoe_tpu_torch.codec.container import save_model
    from smoe_tpu_torch.io.images import read_image, write_image
    png = write_image(_toy(), str(tmp_path / "img"), 2, yuv=False)
    orig, _, _ = read_image(png)
    s = Smoe(orig, kernels_per_dim=[4], device="cpu")
    s.set_optimizer()
    s.run_batched_chunk(40)
    pkl = str(tmp_path / "params.pkl")
    save_model(pkl, s.get_params(), s.cfg)
    eager_bytes, eager_log = _reconstruct(png, pkl, str(tmp_path / "e"))
    ReplayingGraph.made = []
    for mod in (ttr, serve):
        monkeypatch.setattr(mod, "graphed",
                            lambda device: not graph._EAGER[0])
    for mod in (ttr, graph):
        monkeypatch.setattr(mod, "warm_up", lambda fn: fn())
        monkeypatch.setattr(mod, "SweepGraph", ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    graph_bytes, graph_log = _reconstruct(png, pkl, str(tmp_path / "g"))
    assert graph_bytes == eager_bytes
    assert graph_log.replace(str(tmp_path / "g"), "") == \
        eager_log.replace(str(tmp_path / "e"), "")
    assert "auto-bd" in graph_log and "prune: keeping" in graph_log
    # dozens of quantized evals replay a program a key: the anchors the
    # encode tries (a field of the config, which the key holds) and the
    # reconstruction's eval each make their own
    assert 1 <= len(ReplayingGraph.made) <= 5
    assert sum(g.replays for g in ReplayingGraph.made) >= 20
