"""The port's dual-model video fit against the benchmark's plain PyTorch
reference (benchmark/reference/smoe_video_ref.py, loaded by path) on the
CPU: a seeded 24 x 32 x 4 clip with a square moving against the pan,
[3, 3, 2] kernels in 4 blocks, after two time slabs were reseeded, with
seeded random correlations, slopes and motion rows.  Both paths of the
sweep run: the plain one and the fused op's plain versions (K1 / K2's
arithmetic at F = 26).

Tolerances:
  * the loss: rtol 1e-5, sums of < 10^4 float32 terms in another order;
  * a leaf's gradient: 2e-3 of its largest entry; the steering's terms of
    the quadratic-feature maha cancel (B x^2 against -2 B mu x and mu B
    mu at t' = -5), which leaves float32's rounding at ~1e-4 of the
    largest entry (the fused op sums its 26 features in another order);
  * one Adam step from the sweep's gradient and the trainer's moments:
    rtol 1e-4 and 1e-5 of the leaf's largest move (torch.optim.Adam's
    capturable form divides in another order);
  * the lists (probe-near, survivors, the next sweep's): equal.
A planted fault (model 0 fed the raw coordinates, or the model mask
inverted) moves the loss by more than 1e-3 and fails."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from smoe_tpu_torch.config import OptConfig  # noqa: E402
from smoe_tpu_torch.fit import trainer as T  # noqa: E402
from smoe_tpu_torch.fit.blocks import update_kernel_lists  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "benchmark", "reference", "smoe_video_ref.py")
CFG = {"precision": 8, "use_yuv": True, "use_determinant": True,
       "probe_maha": 100.0}
BLOCK = (24, 16, 2)


def _ref_module():
    spec = importlib.util.spec_from_file_location("smoe_video_ref_t", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VR = _ref_module()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moving_clip(seed=5, h=24, w=32, t=4):
    """A noisy sinusoid canvas panned 1 px a frame, an 8 x 8 ramp square
    moving 2 px down and 3 px right a frame against it, the frames in YUV
    as the fit reads them; and the pan's affines."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w + t] / np.array([h - 1, w - 1])[:, None, None]
    wide = np.stack([0.5 + 0.3 * np.sin(6 * x + 2 * y),
                     0.5 + 0.25 * np.cos(4 * x * y + 1.0),
                     0.4 + 0.3 * np.sin(3 * (x + y))], -1)
    wide += rng.normal(0, 0.005, wide.shape)
    yy, xx = np.mgrid[0:8, 0:8] / 7.0
    patch = np.stack([0.2 + 0.6 * yy, 0.7 - 0.5 * xx, 0.5 + 0.4 * yy * xx],
                     -1)
    frames = []
    for i in range(t):
        f = wide[:, i:i + w].copy()
        f[4 + 2 * i:12 + 2 * i, 3 + 3 * i:11 + 3 * i] = patch
        frames.append(f)
    vid = np.clip(np.stack(frames, 2), 0, 1).astype(np.float32)
    affines = np.zeros((t, 2, 3), np.float32)
    affines[:, 0, 0] = affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -np.arange(t)
    return vid, affines


def trainer(use_pallas: str):
    """The recipe's dual-model trainer on the clip after two reseeded
    slabs, then seeded random correlations, slopes and motion rows."""
    vid, affines = moving_clip()
    s = T.Smoe(vid, kernels_per_dim=[3, 3, 2], affines=affines,
               init_flag=1, start_batches=4, normalize_pis=False,
               quantize_pis=True, probe_maha_threshold=100.0, probe_grid=5,
               in_graph_ukl=True, use_pallas=use_pallas, device="cpu")
    assert s.cfg.block_shape == BLOCK
    s.set_optimizer()
    s.run_batched_chunk(3)
    s.set_optimizer(OptConfig(lr_div=10.0))
    s.reseed_time_slab(0, rng=0)
    s.reseed_time_slab(1, rng=1)
    rng = np.random.default_rng(11)
    k = s.cfg.capacity
    with torch.no_grad():
        # sharper kernels, so that a block's list is not every kernel
        s.params.a_diag.mul_(3.0)
        s.params.a_corr.copy_(torch.as_tensor(np.tril(
            rng.normal(0, 2.0, (k, 3, 3)), -1).astype(np.float32)))
        s.params.gamma_e.copy_(torch.as_tensor(
            rng.normal(0, 0.1, (k, 3, 3)).astype(np.float32)))
        m = s.params.motion.numpy().copy()
        m[[0, 1, 3, 4]] += rng.normal(0, 0.02, (4, m.shape[1]))
        m[[2, 5]] += rng.normal(0, 0.01, (2, m.shape[1]))
        s.params.motion.copy_(torch.as_tensor(m.astype(np.float32)))
    s.run_batched_chunk(2)         # Adam's moments away from zero
    return s


@pytest.fixture(scope="module", params=["off", "on"],
                ids=["plain", "fused"])
def pair(request):
    s = trainer(request.param)
    ref = VR.VideoRef(CFG)
    blocks = VR.VideoBlocks(s.image, BLOCK, "cpu", 5)
    return s, ref, blocks


def ref_params(s):
    return VR.params_on(
        {f: getattr(s.params, f).detach().numpy() for f in VR.FIELDS},
        s.model_mask.numpy(), s.params.motion.detach().numpy(), "cpu")


def port_near(s):
    eff = T.effective_params(s.params, s.cfg, s.musX_grid)
    with torch.no_grad():
        return update_kernel_lists(eff.A, eff.musX, eff.pis, s.cfg, s.bset,
                                   torch.zeros_like(s.kernel_lists),
                                   **s._probe_args(eff))


def port_sweep(s, lists):
    """The sweep's (loss, gradients by field, survivors) on `lists`, as the
    trainer's capped sweep runs it on the fused path."""
    k_cap = None
    if s.fused:
        k_cap = s._cap_bucket(int(lists.sum(1).max()) + 128)
    loss, _, surv, _ = s._sweep_grads(lists.clone(),
                                      T.RegWeights(0.0, 0.0, 0.0), None,
                                      k_cap)
    return float(loss), {f: getattr(s.params, f).grad.clone()
                         for f in VR.FIELDS}, surv


def test_the_clip_has_every_kernel_kind(pair):
    """Both models live, the slabs' raw-domain kernels among them, and
    nonzero correlations and slopes."""
    s, ref, _ = pair
    live = ref.live(ref_params(s))
    mm = s.model_mask
    assert int((live & mm).sum()) == 18 and int((live & ~mm).sum()) == 18
    assert float(s.params.a_corr.detach().abs().max()) > 1.0


def test_coordinates_and_probes_are_the_trainers(pair):
    s, _, blocks = pair
    assert torch.equal(blocks.coords, s.bset.coords)
    assert torch.equal(blocks.targets, s.bset.targets)
    assert torch.equal(blocks.probes, s.bset.probes)
    tc = T.transform_coords(s.bset.coords.reshape(-1, 3), s.params.motion,
                            6, 4)
    np.testing.assert_array_equal(
        VR.transform(s.bset.coords.reshape(-1, 3), s.params.motion).numpy(),
        tc.detach().numpy())


def test_sweep_loss_and_every_gradient_match(pair):
    s, ref, blocks = pair
    p = ref_params(s)
    lists = ref.near(p, blocks)
    loss, grads, _ = port_sweep(s, lists)
    g_ref, loss_ref, _ = ref.grads(p, blocks, lists)
    assert loss == pytest.approx(loss_ref, rel=1e-5)
    for f in VR.FIELDS:
        scale = float(g_ref[f].abs().max())
        assert scale > 0, f
        np.testing.assert_allclose(grads[f].numpy(), g_ref[f].numpy(),
                                   rtol=0, atol=2e-3 * scale, err_msg=f)


def test_in_graph_lists_match(pair):
    """The probe-near set on the video probe boxes, the sweep's survivors,
    and the next sweep's lists (survivors | probe-near after the step)."""
    s, ref, blocks = pair
    p = ref_params(s)
    near = ref.near(p, blocks)
    assert torch.equal(port_near(s), near)
    assert 0 < int(near.sum()) < near.numel()
    _, _, surv = port_sweep(s, near)
    _, _, surv_ref = ref.grads(p, blocks, near)
    assert torch.equal(surv, surv_ref)
    # the eval under the in-graph refresh: its survivors of every live
    # kernel become the lists
    s.run_batched(train=False)
    live = ref.live(p)[None, :].expand(blocks.count, -1).clone()
    assert torch.equal(s.kernel_lists, ref.survivors(p, blocks, live))


def test_one_adam_step_matches(pair):
    """One sweep and its Adam step from the trainer's state: the
    reference's Adam, started from the trainer's moments, takes the step
    from the gradient the sweep summed; and the lists the sweep leaves are
    its survivors | the probe-near set of the stepped params."""
    s, ref, blocks = pair
    p = ref_params(s)
    st = {f: s.optimizer.state[getattr(s.params, f)] for f in VR.FIELDS}
    opt = VR.Adam(1e-3, 10.0, 1000.0,
                  m={f: st[f]["exp_avg"].clone() for f in VR.FIELDS},
                  v={f: st[f]["exp_avg_sq"].clone() for f in VR.FIELDS},
                  t=int(st["pis"]["step"]))
    near = ref.near(p, blocks)
    _, _, surv = ref.grads(p, blocks, near)
    lists, row = s._sweep_buffers()
    lists.copy_(near)
    s._sweep(lists, row, T.RegWeights(0.0, 0.0, 0.0), None,
             s._cap_bucket(int(near.sum(1).max()) + 128) if s.fused
             else None, None, 0.0, True, False, True)
    want = opt.step(p, {f: getattr(s.params, f).grad for f in VR.FIELDS})
    for f in VR.FIELDS:
        got = getattr(s.params, f).detach()
        step = want[f] - p[f]
        np.testing.assert_allclose(
            (got - p[f]).numpy(), step.numpy(), rtol=1e-4,
            atol=1e-5 * float(step.abs().max()), err_msg=f)
    assert torch.equal(lists, surv | ref.near(ref_params(s), blocks))


@pytest.mark.parametrize("fault", ["raw_coords_for_model_0",
                                   "model_mask_inverted"])
def test_a_planted_fault_fails(fault, monkeypatch):
    """The port broken underneath: the comparison's loss tolerance fails
    (the gap is orders of magnitude past 1e-5)."""
    s = trainer("on")
    ref = VR.VideoRef(CFG)
    blocks = VR.VideoBlocks(s.image, BLOCK, "cpu", 5)
    p = ref_params(s)
    lists = ref.near(p, blocks)
    g_ref, loss_ref, _ = ref.grads(p, blocks, lists)
    if fault == "raw_coords_for_model_0":
        monkeypatch.setattr(T, "transform_coords", lambda c, *a: c)
    else:
        s.model_mask = ~s.model_mask
    loss, _, _ = port_sweep(s, lists)
    assert abs(loss - loss_ref) > 1e-3 * loss_ref
