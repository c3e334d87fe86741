"""PyTorch port: the certain-cull test the Hopper kernels K1 and K2 use to
skip work (kernels/csrc/gate_expert_common.cuh, CULL_MARGIN), the
denominator K1 hands K2, and the trainer's refusal to fall back to the CPU.

A pair (pixel n, kernel k) with n_w < fl(fl(thr * denom_n) * (1 - 2^-20))
has fl(n_w / denom_n) <= thr, so the cull `w > thr` drops it and the kernels
may skip its division; K1 skips a kernel for a whole CTA when its largest
n_w there is below the same bound at the CTA's smallest denominator.  The
implication is checked here in fp32 with numpy (IEEE single, round to
nearest, as the card computes without --use_fast_math), near and at the
threshold, with subnormal n_w and with the denominator at its 1e-11 floor."""

import pathlib
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

import jax  # noqa: E402,F401  (the JAX package is the reference here)

from smoe_tpu_torch.kernels import build  # noqa: E402
from smoe_tpu_torch.kernels import gate_expert as tge  # noqa: E402

from test_torch_gate_expert import _case  # noqa: E402

f32 = np.float32
MARGIN = f32(1.0) - f32(2.0 ** -20)
FLOOR = f32(1e-11)
THRS = [f32(0.5 / 2 ** p) for p in (8, 6, 10, 12)]   # precision 8 first


def cut_of(thr, d):
    """The kernels' bound: fl(fl(thr * d) * MARGIN), in fp32."""
    return f32(f32(thr * d) * MARGIN)


def culled(n_w, d, thr):
    """The cull as the kernels evaluate it: not (fl(n_w / d) > thr)."""
    return not (f32(n_w / d) > thr)


# denominators from the floor up; the sums of up to K weights pi*det
denoms = st.one_of(st.just(float(FLOOR)),
                   st.floats(float(FLOOR), float(f32(1e-6)), width=32),
                   st.floats(float(f32(1e-6)), float(f32(1e8)), width=32))
# a weight strictly below the bound: ulps under it, a share of it, or tiny
below = st.one_of(st.integers(1, 1 << 22).map(lambda u: ("ulps", u)),
                  st.floats(0.0, 1.0, width=32, exclude_max=True).map(
                      lambda r: ("share", r)),
                  st.floats(0.0, float(np.finfo(f32).tiny), width=32).map(
                      lambda v: ("tiny", v)))


def _below(cut, how):
    kind, v = how
    if kind == "ulps":
        return f32(max(f32(0.0), f32(cut) - f32(v) * np.spacing(f32(cut))))
    if kind == "share":
        return f32(f32(v) * cut)
    return f32(v)


@settings(max_examples=400, deadline=None)
@given(d=denoms, thr=st.sampled_from(THRS), how=below)
def test_below_the_cut_is_culled(d, thr, how):
    """n_w < fl(fl(thr * d) * MARGIN) implies fl(n_w / d) <= thr, also for
    the largest float below the bound and for subnormal n_w."""
    d = f32(d)
    cut = cut_of(thr, d)
    for n_w in (_below(cut, how), np.nextafter(cut, f32(0.0))):
        assert n_w < cut
        assert culled(n_w, d, thr), (n_w, d, thr)
    # the bound sits under the exact thr * d: the margin is not empty
    assert float(cut) < float(thr) * float(d)


@settings(max_examples=400, deadline=None)
@given(dmin=denoms, ratio=st.floats(1.0, float(f32(1e6)), width=32),
       thr=st.sampled_from(THRS), how=below)
def test_below_the_cta_cut_is_culled_everywhere(dmin, ratio, thr, how):
    """K1's CTA form: a kernel whose CTA max n_w is below the bound at the
    smallest denominator dmin is culled at every pixel with d >= dmin."""
    dmin = f32(dmin)
    d = max(dmin, f32(dmin * f32(ratio)))
    cut_min = cut_of(thr, dmin)
    assert cut_min <= cut_of(thr, d)            # the bound is monotone in d
    cmax = _below(cut_min, how)
    for n_w in (cmax, f32(cmax * f32(0.5)), f32(0.0)):   # any n_w <= cmax
        assert n_w < cut_min
        assert culled(n_w, d, thr), (n_w, d, dmin, thr)


def test_dn0_is_the_culled_pairs_dn_bit_for_bit():
    """K2 gives a culled pair dn = (0 - s_sl) / denom, today's
    (dwt - s_sl) / denom with dwt = +0, signed zeros included: 0 - (+0) is
    +0, whereas -s_sl would be -0."""
    rng = np.random.default_rng(0)
    s = np.concatenate([f32([0.0, -0.0, 1e-45, -1e-45, 1e-38, -3.5]),
                        rng.normal(0, 1, 200).astype(f32)])
    den = np.concatenate([f32([1e-11, 1.0, 3e7]),
                          rng.uniform(1e-3, 1e3, 203).astype(f32)])[:s.size]
    dwt = np.zeros_like(s)                       # +0: the culled pair's dw
    old = (dwt - s) / den
    dn0 = (f32(0.0) - s) / den
    assert old.dtype == dn0.dtype == f32
    assert np.array_equal(old.view(np.uint32), dn0.view(np.uint32))
    assert not np.signbit(dn0[0]) and np.signbit((-s / den)[0])
    src = pathlib.Path(build.SRC_DIR, "gate_expert_bwd.cu").read_text()
    assert "__fdiv_rn(__fsub_rn(0.f, sl), denom)" in src


def test_live_is_denom_above_the_floor():
    """K2 reads live = raw > floor as denom > floor from K1's buffer."""
    raw = f32([0.0, 1e-12, 1e-11, np.nextafter(f32(1e-11), f32(1)), 2.0,
               np.inf, np.nan])
    denom = np.fmax(FLOOR, raw)                  # fmaxf: NaN -> the floor
    assert np.array_equal(raw > FLOOR, denom > FLOOR)


def test_bwd_reference_with_its_denominator_equals_it_without():
    """gate_expert_bwd_reference given the denominator it would recompute
    returns the same bits; given another, other values (it is used)."""
    rng = np.random.default_rng(3)
    phi, xe, q, G, pi_det, mask = map(torch.as_tensor,
                                      _case(2, 3, n=150, k=29, seed=8))
    q_s = q * (-0.5 * mask)[:, None]
    g = torch.as_tensor(rng.normal(0, 1, (150, 3)).astype(f32))
    n_w = torch.exp(torch.minimum(phi @ q_s.T, phi.new_zeros(()))) \
        * pi_det[None, :]
    denom = torch.maximum(phi.new_full((), float(FLOOR)), n_w.sum(1))
    thr = float(THRS[0])
    base = tge.gate_expert_bwd_reference(phi, xe, q_s, G, pi_det, g, thr,
                                         float(FLOOR))
    given_ = tge.gate_expert_bwd_reference(phi, xe, q_s, G, pi_det, g, thr,
                                           float(FLOOR), denom=denom)
    via_wrapper = tge.gate_expert_bwd(phi, xe, q_s, G, pi_det, g, thr,
                                      float(FLOOR), denom=denom)
    for a, b, c in zip(base, given_, via_wrapper):
        assert torch.equal(a, b) and torch.equal(a, c)
    other = tge.gate_expert_bwd_reference(phi, xe, q_s, G, pi_det, g, thr,
                                          float(FLOOR), denom=denom * 2)
    assert not torch.equal(other[2], base[2])


def test_cpu_tensors_refuse_the_kernel_outputs():
    """The CPU path of gate_expert_fwd is the plain version: it refuses
    `denom_out` and `stats`, which only the kernel writes."""
    args = list(map(torch.as_tensor, _case(2, 3, n=70, k=23, seed=9)))
    thr = float(THRS[0])
    res, surv = tge.gate_expert_fwd(*args, thr, float(FLOOR))
    ref = tge.gate_expert_reference(*args, thr, float(FLOOR))
    assert torch.equal(res, ref[0]) and torch.equal(surv, ref[1])
    with pytest.raises(ValueError, match="denom_out and stats"):
        tge.gate_expert_fwd(*args, thr, float(FLOOR),
                            denom_out=torch.empty(70))
    with pytest.raises(ValueError, match="denom_out and stats"):
        tge.gate_expert_fwd(*args, thr, float(FLOOR),
                            stats=torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("d,e", [(2, 3), (4, 5)])
def test_skipping_non_candidates_keeps_the_plain_result(d, e):
    """K1's CTA rule in plain fp32 arithmetic, on model-shaped inputs in
    raster order: per block of 256 pixels, the kernels whose largest n_w is
    below the bound at the block's smallest denominator are culled at every
    pixel of the block, so dropping them changes no weight."""
    phi, xe, q, G, pi_det, mask = map(torch.as_tensor,
                                      _case(d, e, n=1024, k=40, seed=11))
    order = torch.argsort(phi[:, 1])             # neighbours together
    phi = phi[order]
    q_s = q * (-0.5 * mask)[:, None]
    n_w = torch.exp(torch.minimum(phi @ q_s.T, phi.new_zeros(()))) \
        * pi_det[None, :]
    denom = torch.maximum(phi.new_full((), float(FLOOR)), n_w.sum(1))
    thr = THRS[0]
    w = n_w / denom[:, None]
    w = torch.where(w > float(thr), w, torch.zeros_like(w))
    skipped = 0
    for b in range(0, 1024, 256):
        cmax = n_w[b:b + 256].amax(0).numpy()
        cut = cut_of(thr, f32(denom[b:b + 256].min()))
        out = cmax < cut
        skipped += int(out.sum())
        assert not w[b:b + 256][:, torch.as_tensor(out)].any()
    assert skipped > 0                           # the rule has work to do


def test_margin_constant_in_the_kernel_sources():
    """Both kernels take their bound from the shared header, and the header
    holds the margin these tests check: 1 - 2^-20."""
    hdr = pathlib.Path(build.SRC_DIR, "gate_expert_common.cuh").read_text()
    m = re.search(r"constexpr float CULL_MARGIN = 1\.0f - 0x1p-(\d+)f;",
                  hdr)
    assert m and int(m.group(1)) == 20 and MARGIN == f32(1 - 2.0 ** -20)
    assert "__fmul_rn(__fmul_rn(thr, d), CULL_MARGIN)" in hdr
    body = pathlib.Path(build.SRC_DIR, "gate_expert_fwd_body.cuh").read_text()
    assert '#include "gate_expert_common.cuh"' in body
    for name in ("gate_expert_fwd", "gate_expert_bwd"):
        src = pathlib.Path(build.SRC_DIR, name + ".cu").read_text()
        assert '#include "gate_expert_common.cuh"' in src
        if '#include "gate_expert_fwd_body.cuh"' in src:
            src += body              # K1's loop is the forward body's
        assert "cull_cut(thr, " in src
        code = "\n".join(line.split("//")[0] for line in src.splitlines())
        assert "0x1p-" not in code                # no second constant


def test_smoe_without_a_card_raises(monkeypatch):
    """Smoe(img) means the card: without one it raises, naming
    device="cpu", and fits nothing on the CPU."""
    from smoe_tpu_torch.fit.trainer import Smoe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.full((16, 16, 3), 0.5, np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Smoe(img, kernels_per_dim=[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Smoe(img, kernels_per_dim=[2], device="cuda")
    assert Smoe(img, kernels_per_dim=[2], device="cpu").device.type == "cpu"
