"""PyTorch port: parameter container and steering-factor assembly against
the JAX package (smoe_tpu/core/params.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from smoe_tpu.config import SmoeConfig as JConfig  # noqa: E402
from smoe_tpu.core import params as jparams  # noqa: E402
from smoe_tpu.core.init import init_params as j_init_params  # noqa: E402
from smoe_tpu_torch.config import SmoeConfig  # noqa: E402
from smoe_tpu_torch.core import params as tparams  # noqa: E402
from smoe_tpu_torch.core.init import init_params as t_init_params  # noqa: E402

CASES = {
    "cholesky": {},
    "radial": {"radial_as": True},
    "inverse_cov": {"train_inverse_cov": True},
}


def _image(d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, (10,) * d + (3,)).astype(np.float32)


def _perturbed(d, kw, seed=1):
    """JAX init_params output with non-trivial correlations."""
    cfg = JConfig(dim_domain=d, kernels_per_dim=(3,) * d, **kw)
    p = j_init_params(_image(d), cfg)
    rng = np.random.default_rng(seed)
    if not cfg.radial_as:
        p = p.replace(a_corr=rng.normal(0, 2.0, p.a_corr.shape)
                      .astype(np.float32))
    p = p.replace(a_diag=(np.asarray(p.a_diag) * rng.uniform(
        0.5, 1.5, np.asarray(p.a_diag).shape)).astype(np.float32))
    return cfg, p


@pytest.mark.parametrize("d", [2, 3, 4])
def test_init_params_roundtrip_exact(d):
    cfg, p = _perturbed(d, {})
    tp = tparams.params_from_numpy(p.to_numpy())
    back = tparams.params_to_numpy(tp)
    for f in jparams.SmoeParams.FIELDS:
        v = getattr(p, f)
        if v is None:
            assert f not in back
        else:
            assert back[f].dtype == np.float32
            np.testing.assert_array_equal(back[f], np.asarray(v))


def test_params_from_get_params_dict():
    """The Smoe.get_params() naming (A_diagonal / A_corr, motion rows)
    maps onto the same fields."""
    cfg, p = _perturbed(3, {})
    d = {"pis": p.pis, "musX": p.musX, "A_diagonal": p.a_diag,
         "A_corr": p.a_corr, "nu_e": p.nu_e, "gamma_e": p.gamma_e}
    m = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for i, name in enumerate(("h11", "h12", "h13", "h21", "h22", "h23",
                              "h31", "h32")):
        d[name] = m[i]
    tp = tparams.params_from_numpy(d)
    np.testing.assert_array_equal(tp.a_diag.numpy(), p.a_diag)
    np.testing.assert_array_equal(tp.a_corr.numpy(), p.a_corr)
    np.testing.assert_array_equal(tp.motion.numpy(), m)
    assert tp.capacity == p.pis.shape[0]
    assert tp.dim_domain == 3 and tp.num_channels == 3


@pytest.mark.parametrize("d", [2, 3])
def test_port_init_params_matches_jax(d):
    """The port's numpy init is a copy: identical arrays."""
    kw = {"kernels_per_dim": (3,) * d}
    if d == 3:
        kw["num_frames"] = 10
    img = _image(d, seed=4)
    jp = j_init_params(img, JConfig(dim_domain=d, **kw))
    tp = t_init_params(img, SmoeConfig(dim_domain=d, **kw))
    for f in jparams.SmoeParams.FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [2, 4])
def test_assemble_A_and_diag_exact(case, d):
    cfg, p = _perturbed(d, CASES[case])
    tcfg = SmoeConfig(dim_domain=d, kernels_per_dim=(3,) * d, **CASES[case])
    jp = p.replace(**{f: jnp.asarray(getattr(p, f))
                      for f in ("musX", "a_diag", "a_corr", "pis", "nu_e",
                                "gamma_e")})
    tp = tparams.params_from_numpy(p.to_numpy())
    np.testing.assert_array_equal(
        tparams.assemble_A(tp, tcfg).numpy(),
        np.asarray(jparams.assemble_A(jp, cfg)))
    np.testing.assert_array_equal(
        tparams.diag_of_A(tp, tcfg).numpy(),
        np.asarray(jparams.diag_of_A(jp, cfg)))
