"""PyTorch port: in-graph QAT modes 2 and 3 (core/quant.py) and the SSIM
loss (core/ssim.py) against the JAX package's on the CPU.

Same seeded numpy inputs to both.  Tolerances: QAT forward values and
gradients 1e-6 absolute (the same fp32 ops, apart from op order); SSIM and
its gradient 1e-6 absolute (an 11-tap fp32 filter summed in the same tap
order; the SSIM loss is O(1))."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import quant as jq  # noqa: E402
from smoe_tpu.core import ssim as js  # noqa: E402
from smoe_tpu.core.params import SmoeParams as JParams  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import quant as tq  # noqa: E402
from smoe_tpu_torch.core import ssim as ts  # noqa: E402
from smoe_tpu_torch.core.params import SmoeParams  # noqa: E402

ATOL = 1e-6
FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e")


def _params(k=12, d=2, c=3, seed=0, dead="some"):
    rng = np.random.default_rng(seed)
    a = np.zeros((k, d, d), np.float32)
    a[:, np.arange(d), np.arange(d)] = rng.uniform(5, 40, (k, d))
    p = {"musX": rng.uniform(-0.1, 1.1, (k, d)),
         "a_diag": a,
         "a_corr": np.tril(rng.normal(0, 6, (k, d, d)), -1),
         "pis": rng.uniform(0.01, 0.3, k),
         "nu_e": rng.normal(0.4, 0.8, (k, c)),
         "gamma_e": rng.normal(0, 3, (k, d, c))}
    if dead == "some":
        p["pis"][[1, 4]] = 0.0
        p["pis"][7] = -0.05
    elif dead == "all":
        p["pis"][:] = 0.0
    return {f: np.asarray(v, np.float32) for f, v in p.items()}


def _qat_pair(p, cfg_kw, seed):
    """apply_qat's outputs and the gradient of a weighted sum of them with
    respect to every field, in both packages."""
    rng = np.random.default_rng(seed + 100)
    w = {f: rng.normal(size=v.shape).astype(np.float32) for f, v in p.items()}
    jcfg, tcfg = JConfig(**cfg_kw), SmoeConfig(**cfg_kw)

    def jloss(jp):
        out = jq.apply_qat(JParams(**jp), jcfg)
        return sum(jnp.sum(getattr(out, f) * w[f]) for f in FIELDS), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        {f: jnp.asarray(v) for f, v in p.items()})
    tp = {f: torch.tensor(v, requires_grad=True) for f, v in p.items()}
    tout = tq.apply_qat(SmoeParams(**tp), tcfg)
    loss = sum(torch.sum(getattr(tout, f) * torch.as_tensor(w[f]))
               for f in FIELDS)
    loss.backward()
    return jout, jg, tout, tp


@pytest.mark.parametrize("qm,dead,radial,train_musx", [
    (2, "some", False, True), (3, "some", False, True),
    (3, "some", False, False), (3, "all", False, True),
    (3, "some", True, True), (2, "all", True, True)])
def test_apply_qat_modes_2_3_match_jax(qm, dead, radial, train_musx):
    p = _params(dead=dead)
    if radial:
        p["a_diag"] = np.ascontiguousarray(
            np.diagonal(p["a_diag"], axis1=1, axis2=2)[:, 0])
        p["a_corr"] = np.zeros_like(p["a_corr"])
    cfg_kw = dict(quantization_mode=qm, radial_as=radial,
                  train_musx=train_musx, bit_depths=(10, 8, 6, 10, 8),
                  lower_bounds=(-60.0, -0.3, -3.0, 0.0, -8.0),
                  upper_bounds=(60.0, 1.3, 3.0, 0.5, 8.0))
    jout, jg, tout, tp = _qat_pair(p, cfg_kw, seed=qm)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tout, f).detach().numpy(),
                                   np.asarray(getattr(jout, f)), atol=ATOL,
                                   rtol=0, err_msg=f)
        np.testing.assert_allclose(tp[f].grad.numpy(), np.asarray(jg[f]),
                                   atol=ATOL, rtol=0, err_msg=f"grad {f}")
        assert np.isfinite(getattr(tout, f).detach().numpy()).all()
    if dead == "all" and qm == 3:
        # no active kernel: the bounds collapse to [0, 0], values pass
        # through that degenerate range (pis all quantize to 0)
        assert not np.any(tout.pis.detach().numpy() > 0)


def test_masked_min_max_detaches_and_collapses():
    x = torch.tensor([[1.0, -2.0], [3.0, 5.0], [-7.0, 0.5]],
                     requires_grad=True)
    mn, mx = tq._masked_min_max(x, torch.tensor([True, False, True]))
    assert (float(mn), float(mx)) == (-7.0, 1.0) and not mn.requires_grad
    mn, mx = tq._masked_min_max(x, torch.zeros(3, dtype=torch.bool))
    jmn, jmx = jq._masked_min_max(jnp.asarray(x.detach().numpy()),
                                  jnp.zeros(3, bool))
    assert (float(mn), float(mx)) == (float(jmn), float(jmx)) == (0.0, 0.0)


def test_qat_mode_0_1_unchanged_and_motion_raises():
    p = {f: torch.as_tensor(v) for f, v in _params().items()}
    params = SmoeParams(**p)
    assert tq.apply_qat(params, SmoeConfig(quantization_mode=1)) is params
    # modes 0 and 1 leave the motion rows of a video model as they are
    video = dataclasses.replace(params, motion=torch.rand(8, 3))
    assert tq.apply_qat(video, SmoeConfig(quantization_mode=1)) is video


def _ssim_pair(shape, ndim, use_yuv, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda x: js.ssim_loss(x, jnp.asarray(b), use_yuv, ndim=ndim))(
        jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    tl = ts.ssim_loss(ta, torch.as_tensor(b), use_yuv, ndim=ndim)
    tl.backward()
    return float(jl), np.asarray(jg), float(tl.detach()), ta.grad.numpy()


@pytest.mark.parametrize("shape,ndim,use_yuv", [
    ((13, 17, 3), 2, True), ((13, 17, 3), 2, False), ((21, 11, 1), 2, True),
    ((9, 12, 7, 3), 3, True), ((7, 9, 11, 1), 3, False)])
def test_ssim_loss_and_gradient_match_jax(shape, ndim, use_yuv):
    jl, jg, tl, tg = _ssim_pair(shape, ndim, use_yuv, seed=len(shape))
    assert 0.0 < tl < 1.0
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=0)


def test_symmetric_pad_repeats_the_edge_sample():
    x = np.arange(24, dtype=np.float32).reshape(4, 6, 1)
    want = np.pad(x, [(3, 3), (3, 3), (0, 0)], mode="symmetric")
    got = ts.symmetric_pad(torch.as_tensor(x), 3, 2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts._gauss_1d(), js._gauss_1d())
