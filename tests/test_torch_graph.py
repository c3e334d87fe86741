"""PyTorch port: the training chunk that is captured once and replayed as a
CUDA graph on the card (smoe_tpu_torch/fit/graph.py and
`Smoe.run_batched_chunk`), on the CPU, where the chunk runs eagerly.

* The chunk against a plain eager loop (`reference_chunk`: the
  lists rebound every sweep, the inc rows' gradients rebound on .grad),
  bit for bit: metrics, params, Adam state and lists, on toy cuts of the
  flagship, 1080p (several blocks, capped), the video and light-field
  fits, SV at 50 %, the inc rows, QAT 3 and SSIM.
* The graph key: it changes after every rebinding of a tensor the sweep
  reads or writes and after a change of a value it bakes in; it stays
  across chunks that rebind nothing (the lists are copied into the
  sweep's own buffer, which the setter and the evals never rebind).
* `eager()` nests and restores; no graph is built for CPU tensors; the
  subsampling uniforms are the generator's sequence in sweep and block
  order.
* With a stub capture: the launch counters (a capture takes back what it
  counted, each replay adds it), and the chunk's and `phase_breakdown`'s
  control flow on the graphed path, bit for bit against the eager path
  and, for the chunk, against the JAX trainer's chunk (rtol 2e-3, as
  tests/test_torch_trainer.py holds the two packages).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu_torch.apps.content import build_lf  # noqa: E402
from smoe_tpu_torch.core.params import adam_state_from_numpy  # noqa: E402
from smoe_tpu_torch.fit import graph  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402
from smoe_tpu_torch.fit.blocks import update_kernel_lists  # noqa: E402
from smoe_tpu_torch.fit.trainer import (PARAM_FIELDS, RegWeights,  # noqa: E402
                                        Smoe, effective_params)
from smoe_tpu_torch.kernels import gate_expert as ge  # noqa: E402

RTOL = 2e-3


def _toy(n):
    """bench.build_image's smooth channels at n x n."""
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    return np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                     0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                     0.4 + 0.3 * np.sin(5 * x * y)], -1).astype(np.float32)


def _video(h=12, w=12, t=4):
    """A moving random pattern and its per-frame translation affines."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
    vid = np.stack([np.roll(base, i, axis=1) for i in range(t)], axis=2)
    affines = np.zeros((t, 2, 3), np.float32)
    affines[:, 0, 0] = affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -np.arange(t)
    return vid, affines


# name -> (trainer maker, run_batched_chunk keywords); two chunks of 3
CONFIGS = {
    "flagship_cut": (lambda: Smoe(_toy(16), kernels_per_dim=[4],
                                  use_yuv=True, use_determinant=True,
                                  use_pallas="on", device="cpu"), {}),
    "1080p_cut": (lambda: Smoe(_toy(40), kernels_per_dim=[12],
                               batch_size=(20, 20), use_yuv=True,
                               use_determinant=True, use_pallas="on",
                               device="cpu"), {}),
    "video_cut": (lambda: Smoe(_video()[0], kernels_per_dim=[3, 3, 2],
                               affines=_video()[1], init_flag=1,
                               use_yuv=True, use_determinant=True,
                               use_pallas="on", in_graph_ukl=True,
                               device="cpu"), {}),
    "lf_cut": (lambda: Smoe(build_lf(s=4), kernels_per_dim=[2] * 4,
                            normalize_pis=False, quantization_mode=1,
                            quantize_pis=True, in_graph_ukl=True,
                            probe_maha_threshold=100.0, probe_grid=5,
                            lf_corner_weight=0.1, use_yuv=False,
                            use_pallas="on", device="cpu"), {}),
    "sv_50": (lambda: Smoe(_toy(16), kernels_per_dim=[4], batch_size=(8, 8),
                           train_svs=True, use_yuv=True, use_pallas="on",
                           device="cpu"), {"sampling_percentage": 50}),
    "inc": (lambda: Smoe(_toy(24), kernels_per_dim=[4],
                         add_kernel_slots=16, use_pallas="on",
                         device="cpu"), {"train_inc": True}),
    "qat3": (lambda: Smoe(_toy(16), kernels_per_dim=[4], quantize_pis=True,
                          quantization_mode=3, use_pallas="on",
                          device="cpu"), {}),
    "ssim": (lambda: Smoe(_toy(16), kernels_per_dim=[4], ssim_opt=True,
                          use_pallas="on", device="cpu"), {}),
}


def reference_step(s, train_orig, train_inc):
    """`Smoe._step` as an eager loop writes it: the inc split rebinds
    .grad to freshly masked tensors."""
    clip = s.opt_cfg.grad_clip_value_abs
    params = [getattr(s.params, f) for f in PARAM_FIELDS]
    if clip is not None:
        for p in s._trained():
            p.grad.clamp_(-clip, clip)
    if s.cfg.train_trafo and s.params.motion is not None:
        s.params.motion.grad[:, 0] = 0.0
    if not s.num_inc_kernels and not train_inc:
        if train_orig:
            s.optimizer.step()
        return
    grads = [p.grad for p in params]
    for opt, rows, on in ((s.optimizer, s._main_rows, train_orig),
                          (s.inc_optimizer, ~s._main_rows, train_inc)):
        if not on:
            continue
        for p, g in zip(params, grads):
            p.grad = g * rows.reshape((-1,) + (1,) * (g.ndim - 1))
        opt.step()
    for p, g in zip(params, grads):
        p.grad = g


def reference_chunk(s, n_steps, pis_l1=0.0, u_l1=0.0, sv_l1_sub_l2=0.0,
                    sampling_percentage=100, train_orig=True,
                    train_inc=False, thr_sv=None, use_loss_mask=False):
    """The chunk as a plain eager loop: the lists rebound to each sweep's
    survivors, the metrics stacked at the end (the same sweep functions
    below it, `Smoe._sweep_grads`)."""
    if s.optimizer is None:
        s.set_optimizer()
    reg = RegWeights(float(pis_l1), float(u_l1), float(sv_l1_sub_l2))
    lw = s.loss_mask if use_loss_mask else None
    tsv = 0.0 if thr_sv is None else float(thr_sv)
    sample_n = s._sample_n(sampling_percentage)
    k_cap = s._current_k_cap()
    lists = s._kernel_lists
    rows = []
    for _ in range(int(n_steps)):
        loss, mse, survivors, num_pi = s._sweep_grads(
            lists, reg, lw, k_cap, sample_n, tsv)
        with torch.no_grad():
            num_sv = s._num_sv()
            if train_orig or train_inc:
                reference_step(s, train_orig, train_inc)
            lists = survivors
            if s.cfg.in_graph_ukl and not train_inc:
                eff = effective_params(s._full_params(), s.cfg, s.musX_grid)
                lists = update_kernel_lists(eff.A, eff.musX, eff.pis, s.cfg,
                                            s.bset, lists,
                                            **s._probe_args(eff))
            kmax = torch.max(torch.sum(lists, dim=1))
            rows.append(torch.stack([loss, mse, num_pi.float(),
                                     num_sv.float(), kmax.float()]))
    s._kernel_lists = lists
    s.valid = False
    ys = torch.stack(rows).cpu().numpy()
    kmax_last = int(ys[-1, 4])
    if s.fused:
        cur = s._k_cap_cache[0]
        if s.cfg.in_graph_ukl:
            s._k_cap_cache = (s._cap_bucket(kmax_last + 128),)
        else:
            new = s._cap_bucket(kmax_last)
            if new is not None and (cur is None or new < cur):
                s._k_cap_cache = (new,)
    return (ys[:, 0], ys[:, 1], ys[:, 2].astype(np.int32),
            ys[:, 3].astype(np.int32))


def state(s):
    """Params, both optimizers' state and the lists, as numpy."""
    out = {f: getattr(s.params, f).detach().numpy().copy() for f in s._fields}
    for name, opt in (("adam", s.optimizer), ("inc", s.inc_optimizer)):
        for g in opt.param_groups if opt is not None else ():
            for f, p in zip(g["fields"], g["params"]):
                for k, v in opt.state.get(p, {}).items():
                    out[f"{name}.{f}.{k}"] = v.numpy().copy()
    out["lists"] = s.kernel_lists.numpy().copy()
    return out


def assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.ascontiguousarray(a[k]), np.ascontiguousarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def run_both(name, chunk=None):
    """Two trainers made alike: one through `chunk` (the chunk itself by
    default), the other through `reference_chunk`; two chunks of 3."""
    make, kw = CONFIGS[name]
    a, b = make(), make()
    outs = []
    for s, fn in ((a, chunk or Smoe.run_batched_chunk), (b, reference_chunk)):
        s.set_optimizer()
        outs.append([np.stack(fn(s, 3, **kw)) for _ in range(2)])
    return a, b, outs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunk_equals_the_eager_reference_loop(name):
    a, b, (ya, yb) = run_both(name)
    for x, y in zip(ya, yb):
        assert x.tobytes() == y.tobytes()
    assert_same_bits(state(a), state(b))
    assert np.isfinite(ya[-1]).all()
    if name == "1080p_cut":
        assert a._current_k_cap() == 128 and a.start_batches == 4
    if name == "inc":
        assert a.inc_optimizer.state and a._masked_grads is not None


def _chunk_args(s, **kw):
    """The arguments run_batched_chunk would sweep with (and so key)."""
    lists, row = s._sweep_buffers()
    sample_n = s._sample_n(kw.get("sampling_percentage", 100))
    return (lists, row, RegWeights(0.0, 0.0, 0.0), None, s._current_k_cap(),
            sample_n, 0.0, True, bool(kw.get("train_inc", False)),
            bool(s.cfg.in_graph_ukl and not kw.get("train_inc", False)))


def _key(s, **kw):
    return s._graph_key(_chunk_args(s, **kw))


def _sans_cap(key):
    return key[:3] + key[4:]


def _trained(name="1080p_cut"):
    make, kw = CONFIGS[name]
    s = make()
    s.set_optimizer()
    s.run_batched_chunk(2, **kw)
    return s, kw


def _rebind_params(s):
    s.params = dataclasses.replace(s.params, pis=s.params.pis.detach()
                                   .clone().requires_grad_(True))


def _rebind_grad(s):
    s.params.nu_e.grad = torch.zeros_like(s.params.nu_e)


def _lr(s):
    s.optimizer.param_groups[0]["lr"] *= 0.5


def _fresh_adam_state(s):
    st = s.adam_state_numpy()
    s.set_optimizer()
    s.load_adam_state(adam_state_from_numpy(st["mu"], st["nu"],
                                            st["count"]))


def _restore(s, tmp_path):
    path = str(tmp_path / "ckpt.pkl")
    s.checkpoint(path)
    s.restore(path)


def _apply_inc(s):
    s.apply_inc()


def _grid(s):
    # as load_state_numpy(musX_grid=) installs one
    s.musX_grid = torch.zeros((s.cfg.capacity, s.cfg.dim_domain))


def _model_mask(s):
    # as load_state_numpy(model_mask=) installs one
    s.model_mask = s.model_mask.clone()


def _cap(s):
    s._k_cap_cache = (None,)


def _masks_for_inc(s):
    s._main_rows = s._main_rows.clone()


REBINDINGS = {
    "params": (_rebind_params, "1080p_cut"),
    "reinit": (lambda s: s.reinit(), "1080p_cut"),
    "grad": (_rebind_grad, "1080p_cut"),
    "set_optimizer": (lambda s: s.set_optimizer(), "1080p_cut"),
    "lr": (_lr, "1080p_cut"),
    "load_adam_state_into_a_fresh_optimizer": (_fresh_adam_state,
                                               "1080p_cut"),
    "restore": (_restore, "1080p_cut"),
    "apply_inc": (_apply_inc, "inc"),
    "main_rows": (_masks_for_inc, "inc"),
    "musX_grid": (_grid, "1080p_cut"),
    "model_mask": (_model_mask, "video_cut"),
    "cap": (_cap, "1080p_cut"),
    "reseed_generator": (lambda s: s._reseed_generator(), "sv_50"),
}


@pytest.mark.parametrize("site", sorted(REBINDINGS))
def test_graph_key_changes_after_each_rebinding(site, tmp_path):
    fn, name = REBINDINGS[site]
    s, kw = _trained(name)
    before = _key(s, **kw)
    assert _key(s, **kw) == before
    # the rebound tensors stay alive, so no new one can take an old address
    # (where one does, the graph reads it there, as a new capture would)
    keep = (s.params, s.optimizer, s.inc_optimizer, s._main_rows,  # noqa
            s.model_mask, [getattr(s.params, f).grad for f in s._fields])
    if site == "restore":
        fn(s, tmp_path)
    else:
        fn(s)
    if site in ("set_optimizer", "reinit",
                "load_adam_state_into_a_fresh_optimizer", "restore",
                "apply_inc"):
        # Adam's state is made by the warm-up sweep: key the chunk after it
        s.run_batched_chunk(1, **kw)
    assert _key(s, **kw) != before


def test_loss_mask_enters_the_key():
    s, kw = _trained()
    args = list(_chunk_args(s))
    before = s._graph_key(tuple(args))
    args[3] = torch.ones_like(s.bset.targets[..., 0])
    assert s._graph_key(tuple(args)) != before


@pytest.mark.parametrize("site", ["kernel_lists_setter", "eval",
                                  "update_kernel_list", "set_params",
                                  "load_adam_state_in_place",
                                  "ls_init_experts", "sampling_probs"])
def test_writes_in_place_keep_the_key(site):
    """Sites that write the sweep's inputs in place (or whose tensors the
    chunk copies into its own buffer) keep the key, so the next chunk
    replays, and the chunk reads what they wrote."""
    name = "sv_50" if site == "sampling_probs" else "1080p_cut"
    s, kw = _trained(name)
    before = _sans_cap(_key(s, **kw))
    if site == "kernel_lists_setter":
        s.kernel_lists = torch.ones_like(s.kernel_lists)
    elif site == "eval":
        s.run_batched(train=False)
    elif site == "update_kernel_list":
        s.update_kernel_list()
    elif site == "set_params":
        s.set_params({f: getattr(s.params, f).detach().numpy() * 1.01
                      for f in PARAM_FIELDS})
    elif site == "load_adam_state_in_place":
        st = s.adam_state_numpy()
        s.load_adam_state(adam_state_from_numpy(st["mu"], st["nu"],
                                                st["count"]))
    elif site == "ls_init_experts":
        s.ls_init_experts(mode="kernel")
    else:
        s.run_batched(train=False, update_reconstruction=True)
    # lists that may grow re-derive the capped width: only that may move
    assert _sans_cap(_key(s, **kw)) == before
    # what the chunk reads: the lists it starts from are the trainer's
    lists = s.kernel_lists.clone()
    real = Smoe._sweep_grads
    seen = []

    def spy(self, lists_in, *a, **k):
        seen.append(lists_in.clone())
        return real(self, lists_in, *a, **k)

    Smoe._sweep_grads = spy
    try:
        s.run_batched_chunk(1, **kw)
    finally:
        Smoe._sweep_grads = real
    assert torch.equal(seen[0], lists)


def test_the_key_stays_across_chunks_that_rebind_nothing():
    for name in ("1080p_cut", "inc", "sv_50", "video_cut"):
        s, kw = _trained(name)
        before = _sans_cap(_key(s, **kw))
        s.run_batched_chunk(2, **kw)
        assert _sans_cap(_key(s, **kw)) == before, name


def test_eager_nests_and_restores():
    cuda = torch.device("cuda")
    assert graph.graphed(cuda) and not graph.graphed("cpu")
    with ttr.eager():
        assert not graph.graphed(cuda)
        with ttr.eager():
            assert not graph.graphed(cuda)
        assert not graph.graphed(cuda)
    assert graph.graphed(cuda)
    with pytest.raises(RuntimeError):
        with ttr.eager():
            raise RuntimeError("inside")
    assert graph.graphed(cuda)


def test_subsampled_uniforms_are_the_generators_sequence(monkeypatch):
    s, _ = _trained("sv_50")
    s._reseed_generator()
    drawn = []
    real = ttr.gumbel_topk

    def spy(probs, uniform, sample_n, valid=None):
        drawn.append(uniform.clone())
        return real(probs, uniform, sample_n, valid)

    monkeypatch.setattr(ttr, "gumbel_topk", spy)
    s.run_batched_chunk(3, sampling_percentage=50)
    g = torch.Generator().manual_seed(0)
    nb = s.bset.coords.shape[1]
    want = [torch.clamp(torch.rand((nb,), generator=g), min=1e-20)
            for _ in range(3 * s.start_batches)]
    assert len(drawn) == len(want) == 3 * 4
    for x, y in zip(drawn, want):
        assert torch.equal(x, y)


def test_no_graph_is_built_for_cpu_tensors(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a graph for CPU tensors")

    monkeypatch.setattr(ttr, "SweepGraph", refuse)
    monkeypatch.setattr(ttr, "warm_up", refuse)
    s, kw = _trained()
    s.run_batched_chunk(2, **kw)
    s.phase_breakdown(n_steps=1)
    assert s._graphs == {} and s._graph_pool is None


class StubGraph:
    """torch.cuda.CUDAGraph's surface on the CPU."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_the_capture_held(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    # the stub capture runs the sweep once, as a capture runs its Python
    monkeypatch.setattr(graph, "_capture", lambda g, fn, pool: fn())

    def sweep():                  # what two K1 and three K2 wrappers count
        ge.add_launches(2, 3)

    base = ge.launch_counts()
    gen = torch.Generator()
    g = graph.SweepGraph(sweep, pool=None, generators=(gen,))
    assert g.held == (2, 3) and ge.launch_counts() == base
    assert g.graph.generators == [gen] and g.capture_s >= 0
    for _ in range(4):
        g.replay()
    assert g.graph.replays == 4
    assert ge.launch_counts() == (base[0] + 8, base[1] + 12)
    ge.add_launches(-8, -12)


class ReplayingGraph:
    """A SweepGraph stand-in for the CPU: the capture records fn without
    running it (a capture executes nothing), each replay runs it."""

    made = []

    def __init__(self, fn, pool, generators=()):
        self.fn, self.capture_s = fn, 0.0
        ReplayingGraph.made.append(self)

    def replay(self):
        self.fn()


@pytest.fixture
def replaying(monkeypatch):
    """The graphed path's control flow on the CPU."""
    ReplayingGraph.made = []
    monkeypatch.setattr(ttr, "graphed", lambda device: True)
    monkeypatch.setattr(ttr, "warm_up", lambda fn: fn())
    monkeypatch.setattr(ttr, "SweepGraph", ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return ReplayingGraph.made


@pytest.mark.parametrize("name", ["1080p_cut", "sv_50", "inc", "video_cut"])
def test_graphed_control_flow_equals_the_eager_chunk(replaying, name):
    a, b, (ya, yb) = run_both(name)
    for x, y in zip(ya, yb):
        assert x.tobytes() == y.tobytes()
    assert_same_bits(state(a), state(b))
    # a graph a key: the first chunk captures, the second (capped, or at
    # the same key) captures only where its key changed
    assert len(a._graphs) == len(replaying) >= 1
    if name == "1080p_cut":
        assert len(replaying) == 2          # full width, then capped
    a.run_batched_chunk(3, **CONFIGS[name][1])
    assert len(replaying) == len(a._graphs)


def test_phase_breakdown_through_the_captured_pieces(replaying):
    make, _ = CONFIGS["1080p_cut"]
    s = make()
    s.run_batched_chunk(1)
    ph = s.phase_breakdown(n_steps=2)
    assert set(ph) == {"fwd", "bwd", "opt_metrics", "step", "k_cap"}
    assert ph["step"] > 0 and ph["k_cap"] == 128.0
    # the fwd and fwd + bwd pieces, then the chunk's graph at the cap
    assert len(replaying) == 4


def test_graphed_chunk_tracks_the_jax_chunk(replaying):
    """The slice as a whole: the graphed path's chunk against the JAX
    trainer's compiled chunk on the capped multi-block toy."""
    kw = dict(kernels_per_dim=[12], batch_size=(20, 20), use_pallas="on")
    js = JSmoe(_toy(40), **kw)
    ts = Smoe(_toy(40), device="cpu", **kw)
    out = {}
    for s in (js, ts):
        s.set_optimizer()
        out[s] = [s.run_batched_chunk(5) for _ in range(2)]
    for (jl, jm, jn, _), (tl, tm, tn, _) in zip(out[js], out[ts]):
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        np.testing.assert_allclose(tm, jm, rtol=RTOL)
        np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    assert ts._current_k_cap() == js._current_k_cap() == 128
    assert len(replaying) == 2
