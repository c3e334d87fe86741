"""PyTorch port: the motion-compensated video path (video/motion.py,
video/init_strategies.py, the dual-model forward, the codec; the trainer's
video branches and the reseed in tests/test_torch_video_trainer.py)
against the JAX package on the CPU.

Every case of tests/test_video.py runs on the port and is held against
JAX on the same numpy inputs.  Tolerances, stated where they apply:
  * transform_coords and its gradient: 1e-6 / rtol 1e-5 (elementwise fp32);
  * init_strategies: the copy's output is byte-identical;
  * dual-domain maha: rtol 2e-5 of the row's largest |phi_j q_j| sum (the
    t = -5 plane's products cancel: an fp32 sum carries ~2^-24 of the
    largest partial sum whatever its order), outputs 1e-5 absolute before
    the 8-bit output quantizer, 1 LSB after it, survivors equal;
  * K2's plain version at F = 26 against jax.grad: 1e-4 of max |grad|;
  * trajectories from one carried state: mse rtol 2e-3 over 8 sweeps, as
    tests/test_torch_trainer.py holds the 2D fit; lists and num_pi equal;
  * one Adam step of the motion rows: rtol 1e-4 / atol 1e-7;
  * .smoe: byte-identical from identical params, decodes within 1 LSB.
Pallas runs as the JAX tests run it on the CPU (use_pallas="on":
interpret mode)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.fit import trainer as jtr  # noqa: E402
from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.video import init_strategies as jis  # noqa: E402
from smoe_tpu.video.motion import transform_coords as jtransform  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402
from smoe_tpu_torch.video import init_strategies as tis  # noqa: E402
from smoe_tpu_torch.video.motion import (TIME_PLANE,  # noqa: E402
                                         transform_coords)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FIELDS = ("musX", "a_diag", "a_corr", "pis", "nu_e", "gamma_e", "motion")
RTOL = 2e-3


def make_video(h=12, w=12, t=4, c=3, shift=1.0):
    """tests/test_video.py's clip: a moving random pattern and its
    per-frame translation affines."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (h, w, c)).astype(np.float32)
    vid = np.stack([np.roll(base, i, axis=1) for i in range(t)], axis=2)
    affines = np.zeros((t, 2, 3), np.float32)
    affines[:, 0, 0] = 1.0
    affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -shift * np.arange(t)
    return vid, affines


def _grid(h, w, t):
    ys, xs, ts = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             np.linspace(0, 1, t), indexing="ij")
    return np.stack([ys, xs, ts], -1).reshape(-1, 3).astype(np.float32)


def _motion(npm, t, seed=4):
    """(8, t) motion rows that use every parameter of the model."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 0.05, (8, t)).astype(np.float32)
    m[0] += 1.0
    m[4] += 1.0
    return m


def _pair(vid, jkw=None, **kw):
    """The same video fit in both packages (the port on the CPU)."""
    js = JSmoe(vid, **kw, **(jkw or {}))
    ts = Smoe(vid, device="cpu", **kw)
    return js, ts


def _adam_leaves(opt_state):
    """mu, nu and count of optax's multi-group Adam state, merged over the
    groups, the motion leaf included."""
    def find(x):
        if hasattr(x, "mu"):
            return x
        if isinstance(x, tuple):
            for y in x:
                r = find(y)
                if r is not None:
                    return r
        return find(x.inner_state) if hasattr(x, "inner_state") else None

    mu, nu, count = {}, {}, 0
    for st in opt_state.inner_states.values():
        adam = find(st)
        if adam is None:
            continue
        for f in FIELDS:
            m = getattr(adam.mu, f)
            if hasattr(m, "shape"):
                mu[f] = np.asarray(m)
                nu[f] = np.asarray(getattr(adam.nu, f))
        count = int(adam.count)
    return mu, nu, count


def carry(js, ts):
    """The JAX trainer's whole video state into the port's, as numpy."""
    ts.load_state_numpy(
        {f: np.asarray(getattr(js.params, f)) for f in FIELDS
         if getattr(js.params, f) is not None},
        model_mask=None if js.model_mask is None
        else np.asarray(js.model_mask),
        musX_grid=None if js.musX_grid is None else np.asarray(js.musX_grid),
        kernel_lists=np.asarray(js.kernel_lists),
        num_2d_kernels=js.num_2d_kernels,
        adam=None if js.opt_state is None else _adam_leaves(js.opt_state))


# ---------------- motion transform ----------------

@pytest.mark.parametrize("npm", [2, 4, 6, 8])
def test_transform_coords_matches_jax_non_square(npm):
    h, w, t = 12, 20, 3
    coords, m = _grid(h, w, t), _motion(npm, t)
    out_j = np.asarray(jtransform(jnp.asarray(coords), jnp.asarray(m), npm,
                                  t))
    out_t = transform_coords(torch.as_tensor(coords), torch.as_tensor(m),
                             npm, t).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    assert np.all(out_t[:, 2] == TIME_PLANE)


@pytest.mark.parametrize("npm", [2, 4, 6, 8])
def test_transform_coords_gradient_to_motion(npm):
    """d(sum(w * transform))/d motion in both packages: the port sums each
    frame's pixels in a fixed order where JAX scatter-adds."""
    h, w, t = 6, 10, 3
    coords, m = _grid(h, w, t), _motion(npm, t)
    wts = np.random.default_rng(1).normal(size=(coords.shape[0], 3)) \
        .astype(np.float32)
    g_j = np.asarray(jax.grad(lambda mm: jnp.sum(
        jnp.asarray(wts) * jtransform(jnp.asarray(coords), mm, npm, t)))(
            jnp.asarray(m)))
    mt = torch.as_tensor(m).requires_grad_(True)
    (torch.as_tensor(wts) * transform_coords(torch.as_tensor(coords), mt,
                                             npm, t)).sum().backward()
    np.testing.assert_allclose(mt.grad.numpy(), g_j, rtol=1e-5, atol=1e-5)
    again = torch.as_tensor(m).requires_grad_(True)
    (torch.as_tensor(wts) * transform_coords(torch.as_tensor(coords), again,
                                             npm, t)).sum().backward()
    assert torch.equal(again.grad, mt.grad)


def test_transform_coords_rejects_other_models():
    with pytest.raises(ValueError, match="invalid motion model"):
        transform_coords(torch.zeros((4, 3)), torch.zeros((8, 2)), 3, 2)


@pytest.mark.parametrize("npm", [2, 4, 6])
def test_warp_matches_transform_non_square(npm):
    """tests/test_video.py's case on the port: warp_domain (init) and
    transform_coords (training) agree on non-square frames."""
    rng = np.random.default_rng(4)
    h, w, t = 12, 20, 3
    vid = rng.uniform(0, 1, (h, w, t, 1)).astype(np.float32)
    aff = np.zeros((t, 2, 3), np.float32)
    for i in range(t):
        aff[i, 0, 0] = aff[i, 1, 1] = 1.0
        aff[i, 0, 2] = 3.0 * i
        aff[i, 1, 2] = -2.0 * i
        if npm >= 4:
            aff[i, 0, 1] = 0.05 * i
    m = tis.motion_from_affines(aff, vid.shape)
    np.testing.assert_array_equal(m, jis.motion_from_affines(aff, vid.shape))
    out = transform_coords(torch.as_tensor(_grid(h, w, t)),
                           torch.as_tensor(m), npm, t).numpy()
    warped = tis.warp_domain(vid, aff, npm)
    np.testing.assert_array_equal(warped, jis.warp_domain(vid, aff, npm))
    np.testing.assert_allclose(out, warped.reshape(-1, 3), atol=1e-5)


# ---------------- init strategies: the copy ----------------

@pytest.mark.parametrize("flag", [1, 2, 2.5, 3, 4, 5])
def test_video_kernel_init_copy_is_byte_identical(flag):
    vid, aff = make_video()
    warped = tis.warp_domain(vid, aff, 6)
    assert warped.tobytes() == jis.warp_domain(vid, aff, 6).tobytes()
    assert np.all(warped[..., 2] == TIME_PLANE)
    out_t = tis.video_kernel_init(vid, warped, (3, 3, 2), flag)
    out_j = jis.video_kernel_init(vid, warped, (3, 3, 2), flag)
    assert sorted(out_t) == sorted(out_j)
    for k in out_j:
        assert out_t[k].dtype == out_j[k].dtype
        assert out_t[k].tobytes() == out_j[k].tobytes(), k
    assert out_t["pis"].shape[0] > 0


def test_dual_model_concat_copy():
    m0 = {"musX": np.zeros((2, 3), np.float32),
          "A": np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
          "nu_e": np.full((2, 3), 0.5, np.float32),
          "gamma_e": np.zeros((2, 3, 3), np.float32),
          "pis": np.ones((2,), np.float32)}
    m1 = {k: np.concatenate([v, v], 0) for k, v in m0.items()}
    out_t, mask_t = tis.dual_model_concat(m0, m1)
    out_j, mask_j = jis.dual_model_concat(m0, m1)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(mask_t, [1, 1, 0, 0, 0, 0])
    for k in out_j:
        assert out_t[k].tobytes() == out_j[k].tobytes(), k
    assert np.all(out_t["pis"][2:] == 0)
    assert np.all(out_t["musX"][:2, 2] == TIME_PLANE)


def test_smoke_script_clip_is_bench_video_s():
    """chip_smoke.py's clip is the port's copy of scripts/bench_video.py's
    synthetic clip (apps/content.py:build_video; the card has no JAX side
    to import it from)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import bench_video
    import chip_smoke
    for kw in (dict(h=48, w=64, t=3),
               dict(h=144, w=176, t=4, moving_obj=True)):
        a, b = chip_smoke.build_video(**kw), bench_video.build_video(**kw)
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()


# ---------------- the dual-model forward ----------------

def _video_pair(mode="off", **kw):
    vid, aff = make_video(h=8, w=8, t=3)
    return _pair(vid, kernels_per_dim=[2, 2, 2], affines=aff, init_flag=1,
                 use_pallas=mode, **kw)


def _effs(js, ts):
    with torch.no_grad():
        return (jtr.effective_params(js.params, js.cfg, js.musX_grid),
                ttr.effective_params(ts.params, ts.cfg, ts.musX_grid))


def _set_motion(js, ts, m):
    js.params = js.params.replace(motion=jnp.asarray(m))
    with torch.no_grad():
        ts.params.motion.copy_(torch.as_tensor(m))


def test_video_init_matches_jax():
    js, ts = _video_pair()
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert ts.num_2d_kernels == js.num_2d_kernels == 8
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(ts.params, f).detach().numpy(),
            np.asarray(getattr(js.params, f)), err_msg=f)
    np.testing.assert_array_equal(ts.model_mask.numpy(),
                                  np.asarray(js.model_mask))
    # all-on lists at the start of a motion-compensated fit
    assert ts.kernel_lists.all() and np.asarray(js.kernel_lists).all()
    assert not ts.params.motion.requires_grad


@torch.no_grad()
def test_dual_features_and_maha_match_jax():
    from smoe_tpu.core import model as jm
    from smoe_tpu_torch.core import model as tm
    js, ts = _video_pair()
    je, te = _effs(js, ts)
    coords = np.asarray(js.bset.coords[0])
    ct_j = jtransform(jnp.asarray(coords), je.motion, 6, 3)
    ct_t = transform_coords(torch.as_tensor(coords), te.motion, 6, 3)
    q_j = jm.kernel_quadratics(jnp.einsum("klm,knm->kln", je.A, je.A),
                               je.musX)
    q_t = tm.kernel_quadratics(tm._aat(te.A), te.musX)
    phi_j, q2_j = jm.dual_domain_features(ct_j, jnp.asarray(coords), q_j,
                                          js.model_mask)
    phi_t, q2_t = tm.dual_domain_features(ct_t, torch.as_tensor(coords), q_t,
                                          ts.model_mask)
    assert phi_t.shape == (coords.shape[0], 26) and q2_t.shape == (16, 26)
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), atol=1e-6)
    np.testing.assert_allclose(q2_t.numpy(), np.asarray(q2_j), rtol=1e-6,
                               atol=1e-6)
    # half of every q2 row is exact zeros
    mm = ts.model_mask.numpy()
    assert np.all(q2_t.numpy()[mm, 13:] == 0)
    assert np.all(q2_t.numpy()[~mm, :13] == 0)
    maha_j = np.asarray(jm.maha_from_A(je.A, je.musX, js.cfg, ct_j,
                                       jnp.asarray(coords), js.model_mask))
    maha_t = tm.maha_from_A(te.A, te.musX, ts.cfg, ct_t,
                            torch.as_tensor(coords), ts.model_mask)
    # the products cancel: the error scales with their absolute sum
    scale = (phi_t.abs() @ q2_t.abs().T).numpy()
    assert np.all(np.abs(maha_t.numpy() - maha_j) <= 2e-5 * scale + 1e-6)
    # the one product selects each kernel's own domain
    sel = torch.where(ts.model_mask[None, :],
                      tm.maha_from_A(te.A, te.musX, ts.cfg, ct_t),
                      tm.maha_from_A(te.A, te.musX, ts.cfg,
                                     torch.as_tensor(coords)))
    assert np.all(np.abs(maha_t.numpy() - sel.numpy())
                  <= 2e-5 * scale + 1e-6)


@pytest.mark.parametrize("k_cap", [None, 8])
def test_dual_forward_fused_matches_jax_and_plain(k_cap):
    """_forward_eff on the dual model: the port's fused path (its plain
    version on the CPU) against the port's plain path, JAX's XLA path and
    JAX's Pallas kernel in interpret mode: res within 1 LSB of the 8-bit
    output (a borderline pixel may flip one quantizer step), survivors
    equal (tests/test_video.py:170-176)."""
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(3)
    carry(js, ts)
    je, te = _effs(js, ts)
    coords = js.bset.coords[0]
    tc = ts.bset.coords[0]
    jl, tl = js.kernel_lists[0], ts.kernel_lists[0]
    out_xla = jtr._forward_eff(je, js.cfg, coords, jl, js.model_mask)
    out_pal = jtr._forward_eff(je, js.cfg, coords, jl, js.model_mask,
                               fused=(True, True, k_cap))
    with torch.no_grad():
        out_plain = ttr._forward_eff(te, ts.cfg, tc, tl,
                                     model_mask=ts.model_mask)
        out_fused = ttr._forward_eff(te, ts.cfg, tc, tl, fused=True,
                                     k_cap=k_cap, model_mask=ts.model_mask)
    assert out_fused.w_e is None and out_plain.w_e is not None
    for other in (out_plain.res.numpy(), np.asarray(out_xla.res),
                  np.asarray(out_pal.res)):
        np.testing.assert_allclose(out_fused.res.numpy(), other,
                                   atol=1.01 / 255)
        assert np.mean(out_fused.res.numpy() == other) > 0.98
    for other in (out_plain.survivors.numpy(), np.asarray(out_xla.survivors),
                  np.asarray(out_pal.survivors)):
        np.testing.assert_array_equal(out_fused.survivors.numpy(), other)
    np.testing.assert_allclose(out_plain.w_e.numpy(),
                               np.asarray(out_xla.w_e), atol=2e-4)


def test_forward_fused_refuses_coords_with_gradient():
    from smoe_tpu_torch.core.model import forward_fused
    js, ts = _video_pair()
    _, te = _effs(js, ts)
    c = ts.bset.coords[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        forward_fused(te.A, te.musX, te.nu_e, te.gamma_e, te.pis, ts.cfg, c,
                      ts.kernel_lists[0])


def test_k2_plain_version_at_f26_matches_jax_grad():
    """The plain version of the backward kernel at the dual-model width
    against jax.grad of the JAX fused op (its own custom VJP, in interpret
    mode) on the same operands and cotangent: 1e-4 of max |grad|."""
    from smoe_tpu.kernels.gate_expert import fused_gate_expert
    from smoe_tpu_torch.core.model import fused_op_inputs
    from smoe_tpu_torch.kernels.gate_expert import (gate_expert_bwd_reference,
                                                    gate_expert_fwd)
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(3)
    carry(js, ts)
    _, te = _effs(js, ts)
    with torch.no_grad():
        tc = transform_coords(ts.bset.coords[0], te.motion, 6, 3)
        phi, xe, q, G, pi_det, mask, thr, floor = fused_op_inputs(
            te.A, te.musX, te.nu_e, te.gamma_e, te.pis, ts.cfg, tc,
            ts.kernel_lists[0], coords_raw=ts.bset.coords[0],
            model_mask=ts.model_mask)
    assert phi.shape[1] == 26 and xe.shape[1] == 4 and G.shape[1] == 12
    n = phi.shape[0]
    g = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32) / n
    res_t, _ = gate_expert_fwd(phi, xe, q, G, pi_det, mask, thr, floor)
    q_s = q * (-0.5 * mask)[:, None]
    dq_s, dG, dpi = gate_expert_bwd_reference(phi, xe, q_s, G, pi_det,
                                              torch.as_tensor(g), thr, floor)
    dq = dq_s * (-0.5 * mask)[:, None]

    def loss(q_, G_, pd_):
        res, _ = fused_gate_expert(
            jnp.asarray(phi.numpy()), jnp.asarray(xe.numpy()), q_, G_, pd_,
            jnp.asarray(mask.numpy()), thr, floor, n, True, False)
        return jnp.sum(res * jnp.asarray(g)), res

    (_, res_j), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q.numpy()), jnp.asarray(G.numpy()),
        jnp.asarray(pi_det.numpy()))
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), atol=2e-5)
    for name, a, b in zip(("dq", "dG", "dpi"), (dq, dG, dpi), grads):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max(), name


def test_kernel_sources_instantiate_the_dual_model_width():
    """The CUDA sources cannot be built here: hold their instance lists.
    K1 and K2 each name F = 26 with E in {1, 4} and C in {1, 3}, and their
    `*_supported` functions take F = 26 as d = 3."""
    csrc = os.path.join(ROOT, "smoe_tpu_torch", "kernels", "csrc")
    for name, macro in (("gate_expert_fwd.cu", "X"),
                        ("gate_expert_bwd.cu", "SMOE_CASE")):
        with open(os.path.join(csrc, name)) as fd:
            src = fd.read()
        for e in (1, 4):
            for c in (1, 3):
                assert f"{macro}(26, {e}, {c})" in src, (name, e, c)
        assert "(f == 13 || f == 26) ? 3" in src, name
    from smoe_tpu_torch.kernels import build
    assert not any("fast" in flag for flag in build.NVCC_FLAGS)


# ---------------- the codec ----------------

def _write_both(js, ts, tmp_path):
    """model.smoe of one float state through each package's quantizer and
    writer, the video extras in the header."""
    from smoe_tpu.codec.bitstream import write_bitstream as jw
    from smoe_tpu.codec.quantize import quantize_params as jq
    from smoe_tpu_torch.cli.fit import write_model
    pj = js.get_params()
    qp = jq(pj, js.cfg)
    used = np.asarray(qp["used_kernels"], bool)
    extra = {"shape_of_img": list(js.image.shape[:-1]),
             "dim_of_output": js.image.shape[-1], "use_yuv": js.cfg.use_yuv,
             "use_determinant": js.cfg.use_determinant,
             "train_gammas": js.cfg.train_gammas,
             "motion": np.stack([np.asarray(pj[r], np.float32) for r in
                                 ("h11", "h12", "h13", "h21", "h22", "h23",
                                  "h31", "h32")]).tolist(),
             "num_params_model": int(js.cfg.num_params_model),
             "num_frames": int(js.cfg.num_frames),
             "model_mask": np.asarray(js.model_mask)[used].astype(
                 int).tolist()}
    a, b = str(tmp_path / "jax.smoe"), str(tmp_path / "torch.smoe")
    jw(a, qp, js.cfg, extra=extra)
    write_model(b, ts.get_params(), ts.cfg, ts.image.shape,
                model_mask=ts.model_mask.numpy())
    return a, b


def _fitted_pair():
    js, ts = _video_pair()
    for s in (js, ts):
        s.set_optimizer()
    js.run_batched_chunk(5)
    js.reseed_time_slab(0, rng=0)
    js.run_batched_chunk(3)
    carry(js, ts)
    return js, ts


def test_identical_params_give_byte_identical_dual_model_smoe(tmp_path):
    js, ts = _fitted_pair()
    a, b = _write_both(js, ts, tmp_path)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("reference", [False, True])
def test_one_dual_model_smoe_decodes_within_1_lsb_in_both(tmp_path,
                                                          reference):
    from smoe_tpu.codec.serve import decode_bitstream as jdec
    from smoe_tpu_torch.codec.serve import decode_bitstream as tdec
    js, ts = _fitted_pair()
    a, _ = _write_both(js, ts, tmp_path)
    rec_j = np.asarray(jdec(a))
    rec_t, header = tdec(a, device="cpu", reference=reference,
                         return_header=True)
    assert header.get("motion") is not None
    assert header.get("model_mask") is not None
    assert rec_t.shape == js.image.shape
    lsb = np.abs(np.round(rec_t * 255) - np.round(rec_j * 255))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.99
    # a frame range keeps each frame's own motion
    part = tdec(a, device="cpu", reference=reference, frames=(1, 3))
    np.testing.assert_array_equal(part, rec_t[:, :, 1:3])
    np.testing.assert_array_equal(
        np.round(np.asarray(jdec(a, frames=(1, 3))) * 255),
        np.round(rec_j[:, :, 1:3] * 255))


def test_quantized_eval_matches_decode_on_a_video_model(tmp_path):
    """The trainer's quantized-params eval (the encoder's reconstruction)
    keeps the motion rows: it equals the decode of the file within 1 LSB."""
    from smoe_tpu_torch.codec.quantize import quantize_params, rescaler
    from smoe_tpu_torch.codec.serve import decode_bitstream
    js, ts = _fitted_pair()
    _, b = _write_both(js, ts, tmp_path)
    ts.qparams = quantize_params(ts.get_params(), ts.cfg)
    ts.rparams = rescaler(ts.qparams, ts.cfg)
    assert ts._eff_from_rparams().motion is not None
    ts.run_batched(train=False, update_reconstruction=True,
                   with_quantized_params=True)
    rec = decode_bitstream(b, device="cpu")
    lsb = np.abs(np.round(rec * 255)
                 - np.round(ts.qreconstruction_image * 255))
    assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.99


def test_reloaded_video_pickle_rebuilds_the_dual_model(tmp_path):
    """save_model -> load_model -> Smoe(init_params_dict, model_mask_init):
    the motion rows come back from h11..h32, the mask is padded with True,
    and the eval equals the fitted trainer's."""
    from smoe_tpu_torch.codec.container import load_model, save_model
    js, ts = _fitted_pair()
    path = str(tmp_path / "params.pkl")
    save_model(path, ts.get_params(), ts.cfg,
               model_mask=ts.model_mask.numpy())
    cp = load_model(path)
    vid, _ = make_video(h=8, w=8, t=3)
    back = Smoe(vid, init_params_dict=cp["params"],
                model_mask_init=cp.get("model_mask"),
                kernels_per_dim=cp["kernels_per_dim"],
                num_params_model=int(cp["num_params_model"]),
                num_frames=int(cp["num_frames"]), device="cpu")
    assert back.model_mask is not None and back.params.motion is not None
    np.testing.assert_array_equal(back.params.motion.numpy(),
                                  ts.params.motion.numpy())
    m_back = back.run_batched(train=False, update_reconstruction=True)[1]
    m_fit = ts.run_batched(train=False, update_reconstruction=True)[1]
    np.testing.assert_allclose(m_back, m_fit, rtol=1e-5)


# ---------------- the recorded JAX fit (the card's reference) ----------

def test_recorded_fit_is_reproduced_on_the_cpu():
    """tests/data/video_cut_ref.npz (scripts/make_torch_video_fixture.py):
    the port's plain path follows the recorded JAX trajectory at the
    fixture's size, ends with the same lists and live count, and reseeds
    the recorded rows from the recorded state."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    ref = np.load(os.path.join(DATA, "video_cut_ref.npz"))
    h, w, t = (int(v) for v in ref["shape"])
    vid, aff = chip_smoke.build_video(h=h, w=w, t=t, moving_obj=True)
    ts = Smoe(vid, kernels_per_dim=[int(v) for v in ref["kernels_per_dim"]],
              affines=aff, init_flag=1, use_yuv=True, use_determinant=True,
              device="cpu")
    ts.set_optimizer()
    n = 6
    loss, mse, npi, _ = ts.run_batched_chunk(n)
    np.testing.assert_allclose(mse, ref["mse"][:n], rtol=1e-3)
    np.testing.assert_allclose(loss, ref["loss"][:n], rtol=1e-3)
    np.testing.assert_array_equal(npi, ref["num_pi"][:n])
    ts.load_state_numpy({f: ref["p_" + f] for f in FIELDS},
                        kernel_lists=ref["lists"])
    rows = ts.reseed_time_slab(0, rng=0)
    np.testing.assert_array_equal(rows, ref["reseed_rows"])
    # the draw is error-proportional over 101,376 pixels: where the two
    # reconstructions differ by a quantizer step the cumulative weights
    # shift and a draw can land on a neighbouring pixel
    # (test_torch_video_trainer.py's test_reseed_time_slab_rows_identical
    # feeds both one reconstruction)
    same = np.all(ts.params.musX.detach().numpy()[rows]
                  == ref["reseed_musX"], axis=1)
    assert same.mean() >= 0.5
    _, rmse, rnpi, _ = ts.run_batched(train=True)
    assert rnpi == int(ref["reseed_num_pi"])
    np.testing.assert_allclose(rmse, float(ref["reseed_mse"]), rtol=2e-2)


def test_info_cli_reports_the_video_fields(capsys):
    """cli.info on the recorded JAX file prints the same report as the JAX
    CLI, the motion model and the dual-model split included."""
    from smoe_tpu.cli import info as jinfo
    from smoe_tpu_torch.cli import info as tinfo
    path = os.path.join(DATA, "video_cut.smoe")
    jinfo.main([path, "--breakdown"])
    want = capsys.readouterr().out
    h = tinfo.main([path, "--breakdown"])
    got = capsys.readouterr().out
    assert got == want
    assert "video motion   6-param model, 4 frames, dual-model (72 " \
        "transformed / 36 raw)" in got
    assert h["num_kernels"] == 108


def test_recorded_smoe_decodes_within_1_lsb_of_the_recorded_decode():
    from smoe_tpu_torch.codec.serve import decode_bitstream
    ref = np.load(os.path.join(DATA, "video_cut_ref.npz"))
    stride = int(ref["stride"])
    for reference in (False, True):
        rec = decode_bitstream(os.path.join(DATA, "video_cut.smoe"),
                               device="cpu", reference=reference)
        got = np.round(rec[::stride, ::stride] * 255).astype(np.int32)
        lsb = np.abs(got - ref["sample"].astype(np.int32))
        # the t = -5 plane's maha cancels, so more values sit on a rounding
        # boundary of the output quantizer than in a 2D decode
        assert lsb.max() <= 1 and np.mean(lsb == 0) >= 0.995
