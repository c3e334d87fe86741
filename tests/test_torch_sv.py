"""PyTorch port: the support-vector residual and error-proportional
subsampling (smoe_tpu_torch/fit/trainer.py `sv_residual`, `_RowGather`,
`gumbel_topk`; fit/blocks.py `sv_index`; core/losses.py
`sv_l1_sub_l2_reg`; the fit CLI's -tvs / -svg / -sp) against the JAX
package (smoe_tpu/fit/trainer.py:92-124, 440-501, 614-625) on the CPU.

Every case of tests/test_sv.py runs on the port and is held against JAX
on the same numpy inputs.  Tolerances, stated where they apply:
  * the residual and its gradients: 1e-5 relative (one (Nb, Nb) exact
    fp32 product in each package, summed in different orders);
  * trajectories: per-sweep loss and mse rtol 2e-3 over 30 sweeps (the
    trainer tests' tolerance: the output fake-quantizer rounds), num_pi
    and num_sv equal;
  * the draw: JAX and torch draw different random streams, so the port's
    draw (`gumbel_topk`) is held to JAX's formula on the same uniforms,
    and a subsampled fit is held to JAX's by feeding the port the
    uniforms JAX's key schedule gives (`JaxUniforms`).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from smoe_tpu.fit.trainer import Smoe as JSmoe  # noqa: E402
from smoe_tpu.fit.trainer import _sv_residual  # noqa: E402
from smoe_tpu_torch.fit import trainer as ttr  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402

RTOL = 2e-3


def _img(outliers=((3, 4, 0.9), (6, 1, 0.1)), base=0.5):
    """tests/test_sv.py's image: a constant with outlier pixels."""
    img = np.full((8, 8, 1), base, np.float32)
    for y, x, v in outliers:
        img[y, x, 0] = v
    return img


def _pair(img, **kw):
    kw = {"kernels_per_dim": [2], "train_svs": True, "use_yuv": False,
          "use_determinant": True, **kw}
    js, ts = JSmoe(img, **kw), Smoe(img, device="cpu", **kw)
    js.set_optimizer()
    ts.set_optimizer()
    return js, ts


class JaxUniforms:
    """The uniforms JAX's subsampled sweep draws, replayed on the host:
    one key per chunk from the trainer's PRNGKey(0), one split per sweep,
    one key per block (trainer.py:589-593, 659-661, 1179-1181, 480-481).
    `install(ts)` makes the port's trainer draw them in the same order."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.queue = []

    def chunk(self, n_steps, blocks, nb, sampled):
        # every chunk takes a key, sampled or not
        self.key, rng = jax.random.split(self.key)
        for _ in range(n_steps if sampled else 0):
            rng, sub = jax.random.split(rng)
            for k in jax.random.split(sub, blocks):
                self.queue.append(np.asarray(jax.random.uniform(
                    k, (nb,), minval=1e-20)))

    def install(self, ts):
        chunk = ts.run_batched_chunk

        def run(n_steps, *a, **kw):
            pct = kw.get("sampling_percentage", a[3] if len(a) > 3 else 100)
            self.chunk(int(n_steps), ts.start_batches,
                       int(ts.bset.coords.shape[1]),
                       ts._sample_n(pct) is not None)
            return chunk(n_steps, *a, **kw)

        def draw(n):
            u = self.queue.pop(0)
            assert u.shape == (n,)
            return torch.from_numpy(u.copy())

        ts.run_batched_chunk = run
        ts._sample_uniform = draw


# ---------------- the residual ----------------

def _sv_inputs(n=6, d=2, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (n, d)).astype(np.float32)
    sv = rng.normal(0, 1, (n, 1)).astype(np.float32)
    bw_diag = np.tile((3.0 * np.eye(d, dtype=np.float32))[None], (n, 1, 1))
    bw_corr = rng.normal(0, 0.5, (n, d, d)).astype(np.float32)
    return coords, sv, bw_diag, bw_corr


def test_sv_residual_math():
    """res_sv[b] = sum_a SV_a exp(-(x_b-x_a)^T A_a A_a^T (x_b-x_a)), equal
    to JAX's and to the loop; the gradients equal jax.grad's."""
    coords, sv, bwd, bwc = _sv_inputs()
    res_j, eff_j = _sv_residual(*(jnp.asarray(a) for a in
                                  (coords, sv, bwd, bwc)), jnp.float32(0.0))
    t = [torch.tensor(a, requires_grad=i > 0)
         for i, a in enumerate((coords, sv, bwd, bwc))]
    res_t, eff_t = ttr.sv_residual(*t, 0.0)
    np.testing.assert_allclose(res_t.detach().numpy(), np.asarray(res_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(eff_t.detach().numpy(), np.asarray(eff_j))
    A = np.zeros((6, 2, 2), np.float32)
    for a in range(6):
        A[a] = np.diag(np.diag(bwd[a])) + np.tril(bwc[a], k=-1)
    expected = np.zeros((6,), np.float32)
    for b in range(6):
        for a in range(6):
            dv = coords[b] - coords[a]
            expected[b] += sv[a, 0] * np.exp(-(dv @ A[a] @ A[a].T @ dv))
    np.testing.assert_allclose(res_t.detach().numpy(), expected, rtol=1e-4,
                               atol=1e-5)
    w = np.linspace(-1, 1, 6).astype(np.float32)
    gj = jax.grad(lambda s, d_, c_: jnp.sum(_sv_residual(
        jnp.asarray(coords), s, d_, c_, jnp.float32(0.0))[0] * w),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (sv, bwd, bwc)))
    torch.sum(res_t * torch.as_tensor(w)).backward()
    for a, b in zip(t[1:], gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_sv_threshold_zeroes_small():
    coords = np.random.default_rng(1).uniform(0, 1, (4, 2)).astype(
        np.float32)
    sv = np.array([[0.5], [0.001], [-0.3], [0.0001]], np.float32)
    bw = np.tile(np.eye(2, dtype=np.float32)[None] * 5.0, (4, 1, 1))
    _, eff_j = _sv_residual(jnp.asarray(coords), jnp.asarray(sv),
                            jnp.asarray(bw), jnp.zeros_like(bw),
                            jnp.float32(0.01))
    _, eff_t = ttr.sv_residual(torch.as_tensor(coords), torch.as_tensor(sv),
                               torch.as_tensor(bw),
                               torch.zeros_like(torch.as_tensor(bw)), 0.01)
    np.testing.assert_array_equal(eff_t.numpy(), np.asarray(eff_j))
    np.testing.assert_array_equal(eff_t.numpy()[:, 0] != 0,
                                  [True, False, True, False])


def test_sv_penalty_matches_jax():
    from smoe_tpu.core.losses import sv_l1_sub_l2_reg as jreg
    from smoe_tpu_torch.core.losses import sv_l1_sub_l2_reg as treg
    sv = np.random.default_rng(2).normal(0, 0.1, (64, 1)).astype(np.float32)
    sv[:5] = 0.0
    want = float(jreg(jnp.asarray(sv), jnp.float32(1e-3), 64))
    st = torch.tensor(sv, requires_grad=True)
    got = treg(st, 1e-3, 64)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    gj = jax.grad(lambda s: jreg(s, jnp.float32(1e-3), 64))(jnp.asarray(sv))
    # jnp.abs's derivative at 0 is +1: the zero SVs get the same push
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gj), rtol=1e-6)


# ---------------- the shared grid ----------------

def test_sv_shared_grid_index_map():
    """The port's index map is JAX's: each padded-block position its
    global raster pixel, image-edge pad positions the dummy row."""
    from smoe_tpu.config import SmoeConfig as JConfig
    from smoe_tpu.fit.blocks import build_blockset as jbuild
    from smoe_tpu_torch.config import SmoeConfig
    from smoe_tpu_torch.fit.blocks import build_blockset
    img = np.random.default_rng(0).uniform(0, 1, (8, 8, 1)).astype(
        np.float32)
    kw = dict(dim_domain=2, num_channels=1, kernels_per_dim=(2, 2),
              train_svs=True, sv_shared_grid=True, block_shape=(4, 4),
              overlap=1, use_yuv=False)
    iv = build_blockset(img, SmoeConfig(**kw)).sv_index.numpy()
    np.testing.assert_array_equal(iv, np.asarray(jbuild(img, JConfig(
        **kw)).sv_index))
    assert iv.shape == (4, 36) and iv.dtype == np.int64
    for b, (bi, bj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        for wi in range(6):
            for wj in range(6):
                gi, gj = bi * 4 + wi - 1, bj * 4 + wj - 1
                want = gi * 8 + gj if (0 <= gi < 8 and 0 <= gj < 8) else 64
                assert iv[b, wi * 6 + wj] == want
    no_sv = build_blockset(img, SmoeConfig(**{**kw, "train_svs": False}))
    assert no_sv.sv_index is None


def test_row_gather_backward_is_the_scatter_add():
    """_RowGather's backward (one copy per real row, a fixed-order sum for
    the dummy row) equals autograd's index backward, and reruns give the
    same bits."""
    rng = np.random.default_rng(3)
    src = torch.tensor(rng.normal(size=(9, 2, 2)).astype(np.float32),
                       requires_grad=True)
    idx = torch.tensor([3, 8, 0, 8, 5, 8, 1], dtype=torch.int64)
    g = torch.as_tensor(rng.normal(size=(7, 2, 2)).astype(np.float32))
    grads = []
    for fn in (lambda: ttr._RowGather.apply(src, idx),
               lambda: ttr._RowGather.apply(src, idx),
               lambda: src[idx]):
        src.grad = None
        out = fn()
        np.testing.assert_array_equal(out.detach().numpy(),
                                      src.detach().numpy()[idx.numpy()])
        (out * g).sum().backward()
        grads.append(src.grad.clone())
    assert torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0].numpy(), grads[2].numpy(),
                               rtol=1e-6, atol=1e-7)


# ---------------- training ----------------

@pytest.mark.parametrize("layout", [
    "one_block", "block_local", "shared_grid", "shared_grid_overlap"])
def test_sv_trajectories_track_jax(layout):
    """30 sweeps of an SV fit in both packages from the same init: the
    per-sweep loss and mse, num_pi and num_sv; then an eval with the
    reconstruction: the same SV map, loss and num_sv."""
    kw = {"one_block": {}, "block_local": dict(batch_size=(4, 4)),
          "shared_grid": dict(batch_size=(4, 4), sv_shared_grid=True),
          "shared_grid_overlap": dict(batch_size=(4, 4), sv_shared_grid=True,
                                      overlap=1)}[layout]
    js, ts = _pair(_img(), **kw)
    jl, jm, jn, jsv = js.run_batched_chunk(30)
    tl, tm, tn, tsv = ts.run_batched_chunk(30)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tm, jm, rtol=RTOL)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tsv, jsv)
    assert tsv[-1] > 0
    np.testing.assert_array_equal(ts.kernel_lists.numpy(),
                                  np.asarray(js.kernel_lists))
    # Adam's first, sign-like steps on an SV whose gradient is ~0 follow
    # rounding noise: single coefficients part by a few % of the largest
    sv_j = np.asarray(js.params.sv)
    np.testing.assert_allclose(ts.params.sv.detach().numpy(), sv_j,
                               atol=5e-2 * np.abs(sv_j).max())
    assert ts.params.sv.shape == js.params.sv.shape
    if "shared" in layout:
        assert ts.params.sv.shape == (65, 1)
        assert float(ts.params.sv[64, 0].detach()) == 0.0   # the dummy row
    # the eval with the reconstruction from JAX's state: loss, mse, num_sv,
    # the SV map and the sampling probabilities (the error map over its
    # block's sum)
    ts.load_state_numpy({f: np.asarray(getattr(js.params, f))
                         for f in ts._fields},
                        kernel_lists=np.asarray(js.kernel_lists))
    j = js.run_batched(train=False, update_reconstruction=True)
    t = ts.run_batched(train=False, update_reconstruction=True)
    np.testing.assert_allclose(t[:2], j[:2], rtol=1e-5)
    assert t[2:] == j[2:]
    assert ts.reconstruction_sv.shape == (8, 8)
    # the RBF maha cancels B-scale terms (B = 2 A A^T ~ 70 here): an fp32
    # sum in another order moves a value by ~1e-5 of the map's largest
    np.testing.assert_allclose(ts.reconstruction_sv, js.reconstruction_sv,
                               atol=1e-4 * np.abs(js.reconstruction_sv).max())
    np.testing.assert_allclose(ts.sampling_probs.numpy(),
                               np.asarray(js.sampling_probs), rtol=1e-4,
                               atol=1e-7)


def test_sv_training_absorbs_residual():
    """tests/test_sv.py's one-outlier fit: the SV layer takes residual
    energy in both packages (mse below the start, the SV map set)."""
    js, ts = _pair(_img(((3, 4, 0.9),)))
    m0 = ts.run_batched(train=False)[1]
    for s in (js, ts):
        for _ in range(60):
            s.run_batched(train=True)
    for s in (js, ts):
        loss, mse, _, _ = s.run_batched(train=False,
                                        update_reconstruction=True)
        assert np.isfinite(loss) and mse < m0
        assert s.reconstruction_sv.shape == (8, 8)


def test_shared_grid_overlap_cotrains_and_reruns_identically():
    """Under overlap the shared grid keeps one SV per pixel: the dummy row
    never moves, rows shared between blocks train, and two fits from one
    init give the same bits (the gather's backward has no atomics)."""
    img = _img(((3, 4, 0.9),))
    kw = dict(kernels_per_dim=[2], train_svs=True, sv_shared_grid=True,
              batch_size=(4, 4), overlap=1, use_yuv=False,
              use_determinant=True, device="cpu")
    fits = []
    for _ in range(2):
        s = Smoe(img, **kw)
        s.set_optimizer()
        s.run_batched_chunk(20)
        fits.append(s.params.sv.detach().clone())
    assert torch.equal(fits[0], fits[1])
    sv = fits[0].numpy()
    assert sv[64, 0] == 0.0
    iv = s.bset.sv_index.numpy()
    shared = np.flatnonzero(np.bincount(iv[iv < 64], minlength=64) > 1)
    assert np.any(sv[shared, 0] != 0.0)


def test_sv_reg_and_num_sv_metric():
    """40 sweeps under the SV penalty: num_sv counts |SV| > 5e-3 as JAX's
    does, sweep and eval alike, and the eval loss carries the penalty."""
    img = _img(((2, 2, 0.8),), base=0.4)
    js, ts = _pair(img, use_determinant=False)
    for _ in range(40):
        j = js.run_batched(train=True, sv_l1_sub_l2=1e-4)
        t = ts.run_batched(train=True, sv_l1_sub_l2=1e-4)
    assert t[3] == j[3]
    want = int(np.sum(np.abs(ts.params.sv.detach().numpy()) > 5e-3))
    je = js.run_batched(train=False, sv_l1_sub_l2=1e-4)
    te = ts.run_batched(train=False, sv_l1_sub_l2=1e-4)
    assert te[3] == want == je[3]
    np.testing.assert_allclose(te[0], je[0], rtol=RTOL)
    assert te[0] > ts.run_batched(train=False)[0]


def test_sv_group_takes_its_learning_rate():
    from smoe_tpu_torch.config import OptConfig
    s = Smoe(_img(), kernels_per_dim=[2], train_svs=True, use_yuv=False,
             device="cpu", opt_cfg=OptConfig(base_lr=1e-3, lr_mult_sv=7.0))
    s.set_optimizer()
    groups = {g["name"]: g for g in s.optimizer.param_groups}
    assert groups["sv"]["fields"] == ttr.SV_FIELDS
    assert groups["sv"]["lr"] == pytest.approx(7e-3)
    assert "sv" not in {g["name"] for g in s.inc_optimizer.param_groups}


# ---------------- subsampling ----------------

def _jax_topk(probs, u, n, valid):
    """trainer.py:480-486 on given uniforms."""
    g = -jnp.log(-jnp.log(jnp.asarray(u)))
    scores = jnp.log(jnp.maximum(jnp.asarray(probs), 1e-20)) + g
    if valid is not None:
        v = jnp.asarray(valid)
        scores = jnp.where(v > 0 if v.dtype != jnp.bool_ else v, scores,
                           -jnp.inf)
    return np.asarray(jax.lax.top_k(scores, n)[1])


@pytest.mark.parametrize("valid", ["none", "bool", "float", "all_masked"])
def test_gumbel_topk_is_jax_s_formula(valid):
    """The same indices, in the same order, as JAX's draw on the same
    uniforms; masked pixels only once the valid ones run out, lower index
    first (lax.top_k's order among equal scores)."""
    rng = np.random.default_rng(5)
    nb, n = 256, 100
    err = rng.uniform(0, 1, nb).astype(np.float32) ** 4
    probs = (err / err.sum()).astype(np.float32)
    probs[:7] = 0.0
    u = np.maximum(rng.uniform(0, 1, nb).astype(np.float32), 1e-20)
    v = {"none": None, "bool": rng.uniform(size=nb) > 0.3,
         "float": np.where(rng.uniform(size=nb) > 0.3, 1.0, 0.0).astype(
             np.float32) * rng.choice([0.1, 1.0], nb).astype(np.float32),
         "all_masked": np.arange(nb) < 40}[valid]
    got = ttr.gumbel_topk(torch.as_tensor(probs), torch.as_tensor(u), n,
                          None if v is None else torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(), _jax_topk(probs, u, n, v))
    assert len(set(got.tolist())) == n


def test_jax_uniforms_replay_the_jax_sweep_draw():
    """JaxUniforms replays the uniforms of JAX's compiled sweep: the port
    fed them draws the pixels JAX draws, so one sampled step changes the
    same SV rows, and only sampled ones (tests/test_sv.py
    test_sv_with_pixel_subsampling)."""
    js, ts = _pair(_img())
    JaxUniforms().install(ts)
    sv0 = np.asarray(js.params.sv).copy()
    js.run_batched(train=True, sampling_percentage=50)
    ts.run_batched(train=True, sampling_percentage=50)
    cj = np.flatnonzero(np.asarray(js.params.sv)[:, 0] != sv0[:, 0])
    ct = np.flatnonzero(ts.params.sv.detach().numpy()[:, 0] != sv0[:, 0])
    np.testing.assert_array_equal(ct, cj)
    assert 0 < ct.size <= 32


@pytest.mark.parametrize("kw", [dict(), dict(batch_size=(4, 4)),
                                dict(batch_size=(4, 4), overlap=1)],
                         ids=["one_block", "four_blocks", "overlap"])
def test_subsampled_trajectories_track_jax(kw):
    """10 sweeps at 50 % (the probabilities refreshed by an eval with the
    reconstruction after 5) on JAX's uniforms: the per-sweep loss and mse,
    num_pi and num_sv.  Under overlap both sample nothing."""
    js, ts = _pair(_img(), **kw)
    JaxUniforms().install(ts)
    for _ in range(2):
        j = js.run_batched_chunk(5, sampling_percentage=50)
        t = ts.run_batched_chunk(5, sampling_percentage=50)
        for a, b in zip(t[:2], j[:2]):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        for a, b in zip(t[2:], j[2:]):
            np.testing.assert_array_equal(a, b)
        js.run_batched(train=False, update_reconstruction=True)
        ts.run_batched(train=False, update_reconstruction=True)
    assert (ts._sample_n(50) is None) == ("overlap" in kw)


def test_sampling_is_off_under_ssim_and_overlap():
    s = Smoe(_img(), kernels_per_dim=[2], use_yuv=False, device="cpu")
    assert s._sample_n(50) == 32 and s._sample_n(100) is None
    for kw in (dict(ssim_opt=True), dict(batch_size=(4, 4), overlap=1)):
        s = Smoe(_img(), kernels_per_dim=[2], use_yuv=False, device="cpu",
                 **kw)
        assert s._sample_n(50) is None


def test_sampling_generator_reruns_identically():
    """The draw comes from the trainer's own generator: two fits from one
    init, and a fit after reinit, give the same bits."""
    out = []
    for _ in range(2):
        s = Smoe(_img(), kernels_per_dim=[2], train_svs=True, use_yuv=False,
                 device="cpu")
        s.set_optimizer()
        out.append(s.run_batched_chunk(4, sampling_percentage=40)[1])
    s.reinit()
    out.append(s.run_batched_chunk(4, sampling_percentage=40)[1])
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[0], out[2])


# ---------------- the fit CLI ----------------

CLI_ARMS = {
    "tvs": ["-tvs", "1"],
    "svg": ["-tvs", "1", "-svg", "1", "-bz", "8", "8", "-ovl", "1"],
    "sp": ["-sp", "50"],
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each arm through both CLIs on a 16x16 PNG (-k 2 -n 8 -v 4 -svreg
    1e-4); the port fed JAX's uniforms under -sp."""
    cv2 = pytest.importorskip("cv2")
    from smoe_tpu.cli import fit as jfit
    from smoe_tpu_torch.cli import fit as tfit
    root = tmp_path_factory.mktemp("svcli")
    png = str(root / "img.png")
    y, x = np.mgrid[0:16, 0:16] / 15.0
    img = 0.5 + 0.3 * np.sin(5 * x) * np.cos(3 * y)
    img[5, 7] = 0.95
    cv2.imwrite(png, np.uint8(np.round(img * 255)))
    out = {}
    mp = pytest.MonkeyPatch()
    init = Smoe.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        JaxUniforms().install(self)

    mp.setattr(Smoe, "__init__", patched)
    try:
        for arm, flags in CLI_ARMS.items():
            common = ["-i", png, "-k", "2", "-n", "8", "-v", "4",
                      "-svreg", "1e-4"] + flags
            for pkg, main, extra in (("jax", jfit.main, []),
                                     ("torch", tfit.main,
                                      ["--device", "cpu"])):
                d = str(root / f"{pkg}_{arm}")
                out[pkg, arm] = (main(common + ["-r", d] + extra), d)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("arm", sorted(CLI_ARMS))
def test_sv_and_sampling_cli_track_jax(cli_runs, arm):
    """-tvs 1, -svg 1 (shared grid under overlap) and -sp 50 fit in the
    port: the same validations, kernel counts and SV counts, the mse of
    every validation within 2e-3 of JAX's."""
    rows = {}
    for pkg in ("jax", "torch"):
        with open(os.path.join(cli_runs[pkg, arm][1], "metrics.jsonl")) as f:
            rows[pkg] = [json.loads(line) for line in f]
    j, t = rows["jax"], rows["torch"]
    assert [r["iter"] for r in t] == [r["iter"] for r in j] == [0, 4, 8]
    assert [r["num_kernels"] for r in t] == [r["num_kernels"] for r in j]
    np.testing.assert_allclose([r["mse"] for r in t],
                               [r["mse"] for r in j], rtol=RTOL)
    js, ts = cli_runs["jax", arm][0], cli_runs["torch", arm][0]
    assert ts.num_svs == js.num_svs
    assert ts.cfg.train_svs == js.cfg.train_svs == (arm != "sp")
