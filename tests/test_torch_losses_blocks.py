"""PyTorch port: training losses, QAT modes 0 and 1, block partitioning
and kernel lists against the JAX package (smoe_tpu/core/losses.py,
core/quant.py, core/init.py get_batch_shape, fit/blocks.py).

Same numpy inputs into both packages.  Tolerances: losses and their
gradients rtol 1e-5 / atol 1e-7 (fp32 sums in different orders); block
views, stitching and probe points exact; kernel lists bool-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import losses as JL  # noqa: E402
from smoe_tpu.core import quant as JQ  # noqa: E402
from smoe_tpu.core.init import get_batch_shape as j_batch_shape  # noqa: E402
from smoe_tpu.core.init import init_params  # noqa: E402
from smoe_tpu.core.params import assemble_A as j_assemble_A  # noqa: E402
from smoe_tpu.fit import blocks as JB  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import losses as TL  # noqa: E402
from smoe_tpu_torch.core import quant as TQ  # noqa: E402
from smoe_tpu_torch.core.init import get_batch_shape  # noqa: E402
from smoe_tpu_torch.core.params import (assemble_A,  # noqa: E402
                                        params_from_numpy)
from smoe_tpu_torch.fit import blocks as TB  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-7)


def _img(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.1, 0.9, shape).astype(
        np.float32)


@pytest.mark.parametrize("c,yuv", [(3, True), (3, False), (1, False)])
@pytest.mark.parametrize("masks", ["none", "valid_bool", "valid_float_lw"])
def test_pixel_loss_and_gradient(c, yuv, masks):
    rng = np.random.default_rng(c + 2 * yuv)
    n = 50
    res = rng.uniform(0, 1, (n, c)).astype(np.float32)
    tgt = rng.uniform(0, 1, (n, c)).astype(np.float32)
    res[:5] = tgt[:5]                          # |diff| = 0 ...
    res[5:8] = tgt[5:8] + 0.5 / 256            # ... and |diff| = eps
    valid = lw = None
    if masks == "valid_bool":
        valid = rng.uniform(size=n) > 0.3
    elif masks == "valid_float_lw":
        valid = rng.uniform(0, 1, n).astype(np.float32)
        lw = rng.uniform(0.5, 2, n).astype(np.float32)
    kw = dict(num_channels=c, use_yuv=yuv)
    jcfg, tcfg = JConfig(**kw), SmoeConfig(**kw)

    def j_loss(r):
        la = JL.pixel_loss(r, jnp.asarray(tgt), jcfg,
                           None if lw is None else jnp.asarray(lw),
                           None if valid is None else jnp.asarray(valid))
        return la.loss_pixel, la

    (jl, jla), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(res))
    r = torch.tensor(res, requires_grad=True)
    tla = TL.pixel_loss(r, torch.as_tensor(tgt), tcfg,
                        None if lw is None else torch.as_tensor(lw),
                        None if valid is None else torch.as_tensor(valid))
    tla.loss_pixel.backward()
    for name in ("mse", "err_map", "loss_pixel"):
        np.testing.assert_allclose(getattr(tla, name).detach().numpy(),
                                   np.asarray(getattr(jla, name)), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("kcn", [False, True])
def test_regularizers(kcn):
    img = _img((12, 12, 3))
    kw = dict(kernels_per_dim=(4, 4), kernel_count_as_norm_l1=kcn)
    jcfg, tcfg = JConfig(**kw), SmoeConfig(**kw)
    p = init_params(img, jcfg)
    pis = np.asarray(p.pis).copy()
    pis[[2, 5]] = 0.0
    p = p.replace(pis=pis)
    active = np.ones(16, bool)
    active[::3] = False
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p.to_numpy())
    na = int((pis > 0).sum())
    j1 = JL.pis_l1_reg(jp, jcfg, jnp.asarray(active), jnp.float32(0.3),
                       jnp.asarray(na))
    t1 = TL.pis_l1_reg(tp, tcfg, torch.as_tensor(active), 0.3,
                       torch.tensor(na))
    j2 = JL.bandwidth_l1_reg(jp, jcfg, jnp.asarray(active), jnp.float32(0.2))
    t2 = TL.bandwidth_l1_reg(tp, tcfg, torch.as_tensor(active), 0.2)
    np.testing.assert_allclose(float(t1), float(j1), **TOL)
    np.testing.assert_allclose(float(t2), float(j2), **TOL)


@pytest.mark.parametrize("lo,hi,bits", [(0.0, 2.0, 10), (-5.0, 5.0, 6),
                                        (-0.3, 1.3, 18), (0.0, 0.0, 8)])
def test_fake_quant_value_and_gradient(lo, hi, bits):
    x = np.linspace(lo - 0.5, hi + 0.5, 97).astype(np.float32)
    x = np.concatenate([x, np.array([lo, hi], np.float32)])
    jv, jvjp = jax.vjp(lambda v: JQ.fake_quant(v, lo, hi, bits),
                       jnp.asarray(x))
    (jg,) = jvjp(jnp.ones_like(jv))
    t = torch.tensor(x, requires_grad=True)
    tv = TQ.fake_quant(t, lo, hi, bits)
    tv.sum().backward()
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("qm,qpis", [(0, False), (1, False), (0, True),
                                     (1, True)])
def test_apply_qat_modes_0_and_1(qm, qpis):
    img = _img((12, 12, 3))
    kw = dict(kernels_per_dim=(4, 4), quantization_mode=qm,
              quantize_pis=qpis)
    jcfg, tcfg = JConfig(**kw), SmoeConfig(**kw)
    p = init_params(img, jcfg)
    p = p.replace(pis=np.random.default_rng(1).uniform(
        -0.1, 0.3, 16).astype(np.float32))
    j = JQ.apply_qat(jax.tree_util.tree_map(jnp.asarray, p), jcfg)
    t = TQ.apply_qat(params_from_numpy(p.to_numpy()), tcfg)
    for f in ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("desired,shape", [(1, (512, 512, 5)),
                                           (16, (1080, 1920, 5)),
                                           (5, (32, 48, 5)),
                                           (4, (9, 12, 6, 6)),
                                           (7, (15, 15, 8, 8, 7))])
def test_get_batch_shape(desired, shape):
    assert get_batch_shape(desired, shape) == j_batch_shape(desired, shape)


def test_row_chunks_bounded():
    for nb, width in ((1000, 50), (129600, 576), (811008, 8192), (97, 10 ** 7),
                      (7, 10 ** 9), (12, 10 ** 8)):
        s = TB.row_chunks(nb, width)
        assert nb % s == 0 and 1 <= s <= nb
        if nb * width * 24 <= (2 << 30):
            assert s == 1
        # matches the JAX search wherever that one terminates
        est = -(-nb * width * 24 // (2 << 30))
        if est <= nb:
            assert s == JB.row_chunks(nb, width)
    assert TB.row_chunks(7, 10 ** 9) == 7          # est > nb: one row each


@pytest.mark.parametrize("d,shape,bs,ov", [
    (2, (16, 24, 3), (8, 12), 0), (2, (16, 24, 3), (8, 8), 2),
    (3, (8, 8, 4, 1), (4, 4, 2), 1), (4, (15, 15, 4, 4, 3), (15, 15, 2, 2), 0)])
def test_blockset_and_stitch(d, shape, bs, ov):
    kw = dict(dim_domain=d, num_channels=shape[-1],
              kernels_per_dim=(2,) * d, overlap=ov)
    if d == 4:
        kw["lf_corner_weight"] = 0.0
    img = _img(shape, seed=d)
    jb = JB.build_blockset(img, JConfig(**kw), bs)
    tb = TB.build_blockset(img, SmoeConfig(**kw), bs)
    for f in ("coords", "targets", "valid", "probes", "centers",
              "train_mask"):
        a, b = getattr(tb, f), getattr(jb, f)
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("image_shape", "block_valued", "block_padded", "overlap"):
        assert tuple(np.atleast_1d(getattr(tb, f))) == \
            tuple(np.atleast_1d(getattr(jb, f)))
    np.testing.assert_array_equal(
        TB.stitch_blocks(tb.targets, tb).numpy(),
        np.asarray(JB.stitch_blocks(jb.targets, jb)))
    np.testing.assert_array_equal(TB.stitch_blocks(tb.targets, tb).numpy(),
                                  img)


def test_probe_points_tensor_and_numpy():
    rng = np.random.default_rng(0)
    mins = rng.uniform(0, 0.5, (4, 3)).astype(np.float32)
    maxs = mins + 0.3
    for grid in (3, 5):
        j = np.asarray(JB.probe_points(jnp.asarray(mins), jnp.asarray(maxs),
                                       grid))
        np.testing.assert_array_equal(TB.probe_points(mins, maxs, grid), j)
        np.testing.assert_array_equal(
            TB.probe_points(torch.as_tensor(mins), torch.as_tensor(maxs),
                            grid).numpy(), j)


@pytest.mark.parametrize("kpd,bs,pmt", [((6, 6), (16, 16), 800.0),
                                        ((12, 12), (8, 16), 50.0),
                                        ((4, 4), (32, 32), 800.0)])
def test_kernel_lists_bool_equal(kpd, bs, pmt):
    img = _img((32, 32, 3), seed=4)
    kw = dict(kernels_per_dim=kpd, probe_maha_threshold=pmt)
    jcfg, tcfg = JConfig(**kw), SmoeConfig(**kw)
    p = init_params(img, jcfg)
    rng = np.random.default_rng(2)
    pis = np.asarray(p.pis).copy()
    pis[rng.choice(pis.size, 3, replace=False)] = 0.0
    p = p.replace(pis=pis, a_corr=np.tril(rng.normal(
        0, 2.0, p.a_corr.shape), -1).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p.to_numpy())
    jb = JB.build_blockset(img, jcfg, bs)
    tb = TB.build_blockset(img, tcfg, bs)
    jl = JB.initialize_kernel_lists(j_assemble_A(jp, jcfg), jp.musX, jp.pis,
                                    jcfg, jb)
    tl = TB.initialize_kernel_lists(assemble_A(tp, tcfg), tp.musX, tp.pis,
                                    tcfg, tb)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert not tl.all() and tl.any(0).sum() == (pis > 0).sum()
    base = rng.uniform(size=tl.shape) < 0.1
    ju = JB.update_kernel_lists(j_assemble_A(jp, jcfg), jp.musX, jp.pis,
                                jcfg, jb, jnp.asarray(base))
    tu = TB.update_kernel_lists(assemble_A(tp, tcfg), tp.musX, tp.pis, tcfg,
                                tb, torch.as_tensor(base))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
