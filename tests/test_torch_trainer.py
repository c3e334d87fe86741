"""PyTorch port: the trainer (smoe_tpu_torch/fit/trainer.py) against the
JAX package's `Smoe` (smoe_tpu/fit/trainer.py) on the CPU.

Same image, same config, same init in both packages.  Tolerances:
per-sweep loss and mse rtol 2e-3 over 10 sweeps, as
tests/test_pallas.py test_capped_trainer_sweep_matches_xla holds the
fused trainer to the plain one (the output fake-quantizer rounds, so a
1-ulp difference of res can move a pixel's value by 1/255, and Adam's
first steps normalise the gradients it changes); num_pi and the kernel
lists identical.  One resumed Adam step: rtol 1e-4 / atol 1e-7 on the
parameters.  Within the port, a restored checkpoint and a reinit are bit
for bit."""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402

from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu_torch.core.params import adam_state_from_numpy  # noqa: E402
from smoe_tpu_torch.fit.trainer import PARAM_FIELDS  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402

RTOL = 2e-3


def _toy(n):
    """bench.build_image's smooth channels at n x n: non-separable, so no
    gradient is zero by symmetry alone."""
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    return np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                     0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                     0.4 + 0.3 * np.sin(5 * x * y)], -1).astype(np.float32)


# one block of 16x16 with 16 kernels; 4 blocks of 20x20 with 144 kernels
# (K_pad 256), whose lists hold under 128 kernels, so the capped width
# engages at 128
TOYS = {"one_block": (16, dict(kernels_per_dim=[4])),
        "capped_multi_block": (40, dict(kernels_per_dim=[12],
                                        batch_size=(20, 20)))}


def _fit(cls, toy, mode, **kw):
    """Two chunks of 5 sweeps: the lists shrink to the survivors in the
    first, so the second runs at the capped width where it applies.
    Returns (smoe, [cap of chunk 1, cap of chunk 2], loss, mse, num_pi)."""
    size, tkw = TOYS[toy]
    extra = {"device": "cpu"} if cls is Smoe else {}
    s = cls(_toy(size), use_pallas=mode, **tkw, **kw, **extra)
    s.set_optimizer()
    caps, out = [], []
    for _ in range(2):
        caps.append(s._current_k_cap())
        out.append(s.run_batched_chunk(5)[:3])
    loss, mse, npi = (np.concatenate([np.asarray(o[i]) for o in out])
                      for i in range(3))
    return s, caps, loss, mse, npi


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("toy", sorted(TOYS))
def test_sweeps_track_jax(toy, mode):
    js, jcap, jl, jm, jn = _fit(JSmoe, toy, mode)
    ts, tcap, tl, tmse, tn = _fit(Smoe, toy, mode)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tmse, jm, rtol=RTOL)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    assert tcap == jcap
    if toy == "capped_multi_block" and mode == "on":
        assert tcap == [None, 128]
        assert int(ts.kernel_lists.sum(1).max()) <= 128
    assert tmse[-1] < tmse[0]


def test_in_graph_ukl_tracks_jax():
    js, jcap, jl, jm, jn = _fit(JSmoe, "capped_multi_block", "on",
                                in_graph_ukl=True)
    ts, tcap, tl, tmse, tn = _fit(Smoe, "capped_multi_block", "on",
                                  in_graph_ukl=True)
    np.testing.assert_allclose(tmse, jm, rtol=RTOL)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    assert tcap == jcap
    assert ts._current_k_cap() == js._current_k_cap()
    for s in (js, ts):
        s.run_batched(train=False)
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))


def test_train_cadence_and_best_snapshot():
    """train(): initial eval, chunks to each validation / list boundary,
    final-iterate validation, best snapshot, as the JAX train() does."""
    size, kw = TOYS["one_block"]
    runs = {}
    for cls in (JSmoe, Smoe):
        extra = {"device": "cpu"} if cls is Smoe else {}
        s = cls(_toy(size), **kw, **extra)
        seen = []
        s.train(25, val_iter=10, ukl_iter=5,
                callbacks=[lambda m: seen.append(m.iter)])
        runs[cls] = (s, seen)
    (js, jseen), (ts, tseen) = runs[JSmoe], runs[Smoe]
    assert tseen == jseen == [0, 10, 20, 25]
    assert [i for i, _ in ts.losses] == [i for i, _ in js.losses]
    np.testing.assert_allclose([v for _, v in ts.mses],
                               [v for _, v in js.mses], rtol=RTOL)
    np.testing.assert_allclose(ts.best_loss, js.best_loss, rtol=RTOL)
    assert ts.iter == js.iter == 25
    assert ts.best_loss == min(v for _, v in ts.losses)
    for k in ("pis", "musX", "A_diagonal", "A_corr", "nu_e", "gamma_e"):
        np.testing.assert_allclose(ts.get_best_params()[k],
                                   js.get_best_params()[k], rtol=1e-2,
                                   atol=1e-3, err_msg=k)
    assert ts.get_reconstruction().shape == (size, size, 3)
    assert ts.phase_timer.as_dict()["train_sweeps"]["count"] == 5


def _adam_leaves(opt_state):
    """mu, nu and count of optax's multi-group Adam state, merged over the
    groups (the fields outside a group are empty MaskedNodes; a group set
    to zero holds no Adam state)."""
    def find(x):
        if hasattr(x, "mu"):
            return x
        if isinstance(x, tuple):
            for y in x:
                r = find(y)
                if r is not None:
                    return r
        return find(x.inner_state) if hasattr(x, "inner_state") else None

    mu, nu, count = {}, {}, None
    for st in opt_state.inner_states.values():
        adam = find(st)
        if adam is None:
            continue
        for f in PARAM_FIELDS:
            m = getattr(adam.mu, f)
            if hasattr(m, "shape"):
                mu[f] = np.asarray(m)
                nu[f] = np.asarray(getattr(adam.nu, f))
        count = int(adam.count)
    return mu, nu, count


def test_adam_state_resumes_one_step_like_jax():
    size, kw = TOYS["one_block"]
    js = JSmoe(_toy(size), use_pallas="off", **kw)
    js.set_optimizer()
    js.run_batched_chunk(3)
    ts = Smoe(_toy(size), use_pallas="off", device="cpu", **kw)
    ts.set_optimizer()
    ts.set_params(js.params.to_numpy())
    mu, nu, count = _adam_leaves(js.opt_state)
    assert count == 3 and set(mu) == set(PARAM_FIELDS)
    ts.load_adam_state(adam_state_from_numpy(mu, nu, count))
    ts.kernel_lists = torch.as_tensor(np.array(js.kernel_lists))
    jl, jm, _, _ = js.run_batched_chunk(1)
    tl, tmse, _, _ = ts.run_batched_chunk(1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tmse, jm, rtol=1e-5)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(
            getattr(ts.params, f).detach().numpy(),
            np.asarray(getattr(js.params, f)), rtol=1e-4, atol=1e-7,
            err_msg=f)
    st = ts.adam_state_numpy()
    assert st["count"] == 4
    np.testing.assert_allclose(st["mu"]["nu_e"], _adam_leaves(
        js.opt_state)[0]["nu_e"], rtol=1e-4, atol=1e-9)


def test_quantized_eval_matches_jax():
    """The qm=1 validation: quantize, rescale, and the exact (plain) eval
    of the dequantized params, from the same params in both packages."""
    from smoe_tpu.codec.quantize import quantize_params as jq
    from smoe_tpu.codec.quantize import rescaler as jr
    size, kw = TOYS["capped_multi_block"]
    js = JSmoe(_toy(size), quantization_mode=1, **kw)
    js.set_optimizer()
    js.run_batched_chunk(5)
    ts = Smoe(_toy(size), quantization_mode=1, device="cpu", **kw)
    ts.set_params(js.params.to_numpy())
    ts.kernel_lists = torch.as_tensor(np.array(js.kernel_lists))
    js.qparams = jq(js.get_params(), js.cfg)
    js.rparams = jr(js.qparams, js.cfg)
    ts._quantize_now()
    for k in ("pis", "musX", "nu_e", "A_diagonal", "A_corr", "gamma_e",
              "used_kernels"):
        np.testing.assert_array_equal(ts.qparams[k], js.qparams[k])
    jout = js.run_batched(train=False, update_reconstruction=True,
                          with_quantized_params=True)
    tout = ts.run_batched(train=False, update_reconstruction=True,
                          with_quantized_params=True)
    # both evals end in the output fake-quantizer: a pixel may land one
    # 8-bit step apart, which moves the mse by ~1e-4 relative here
    np.testing.assert_allclose(tout[:2], jout[:2], rtol=RTOL)
    assert tout[2] == jout[2]
    lsb = np.abs(np.round(ts.get_qreconstruction() * 255)
                 - np.round(np.asarray(js.get_qreconstruction()) * 255))
    assert lsb.max() <= 1 and (lsb == 0).mean() >= 0.999
    ts.train(4, val_iter=2)
    assert [i for i, _ in ts.qmses] == [0, 2, 4]


def test_checkpoint_restore_and_reinit_are_exact(tmp_path):
    size, kw = TOYS["capped_multi_block"]
    img = _toy(size)
    a = Smoe(img, use_pallas="on", device="cpu", **kw)
    a.train(6, val_iter=3)
    path = str(tmp_path / "ckpt.pkl")
    a.checkpoint(path)
    with open(path, "rb") as fd:
        state = pickle.load(fd)

    def plain(v):
        if isinstance(v, dict):
            return all(plain(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        return not torch.is_tensor(v) and type(v).__module__ != "torch"
    assert plain(state)
    b = Smoe(img, use_pallas="on", device="cpu", **kw)
    b.restore(path)
    assert b.iter == a.iter == 6 and b.losses == a.losses
    ra = a.run_batched_chunk(3)
    rb = b.run_batched_chunk(3)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(a.params, f), getattr(b.params, f))
    assert torch.equal(a.kernel_lists, b.kernel_lists)

    fresh = Smoe(img, use_pallas="on", device="cpu", **kw)
    fresh.set_optimizer()
    a.reinit()
    assert a.iter == 0 and a.losses == [] and a.best_loss is None
    assert torch.equal(a.kernel_lists, fresh.kernel_lists)
    for x, y in zip(a.run_batched_chunk(4), fresh.run_batched_chunk(4)):
        np.testing.assert_array_equal(x, y)


def test_phase_breakdown_on_cpu():
    size, kw = TOYS["capped_multi_block"]
    s = Smoe(_toy(size), use_pallas="on", device="cpu", **kw)
    s.run_batched_chunk(1)                 # the lists shrink: capped
    ph = s.phase_breakdown(n_steps=2)
    assert set(ph) == {"fwd", "bwd", "opt_metrics", "step", "k_cap"}
    assert ph["step"] > 0 and ph["fwd"] > 0 and ph["k_cap"] == 128.0


def test_phase_timer_matches_jax():
    from smoe_tpu.diag.profile import PhaseTimer as JTimer
    from smoe_tpu_torch.diag.profile import PhaseTimer
    out = []
    for cls in (JTimer, PhaseTimer):
        t = cls()
        for name in ("a", "b", "a"):
            with t.phase(name):
                pass
        d = t.as_dict()
        out.append({k: v["count"] for k, v in d.items()})
        assert "phase" in t.report()
    assert out[0] == out[1] == {"a": 2, "b": 1}
