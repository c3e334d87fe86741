"""The port's spans (smoe_tpu_torch/diag/profile.py:span) on the CPU: the
ranges `Smoe.train`, `Smoe.reseed_time_slab` and `decode_bitstream` open
under a running torch.profiler, their parents and counts, and nothing
recorded without one.  No JAX: the spans are the port's own."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from smoe_tpu_torch.codec.bitstream import read_header  # noqa: E402
from smoe_tpu_torch.codec.serve import decode_bitstream  # noqa: E402
from smoe_tpu_torch.diag.profile import span  # noqa: E402
from smoe_tpu_torch.fit.trainer import Smoe  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "video_cut.smoe")


def _toy(n):
    y, x = np.mgrid[0:n, 0:n] / (n - 1)
    return np.stack([0.5 + 0.3 * np.sin(4 * x + 1.5 * y),
                     0.5 + 0.25 * np.cos(3 * (x - 0.3) * (y + 0.4) * 4),
                     0.4 + 0.3 * np.sin(5 * x * y)], -1).astype(np.float32)


def _spans(prof):
    """The profiler's smoe.* ranges, in order of start."""
    return sorted((e for e in prof.events() if e.name.startswith("smoe.")),
                  key=lambda e: e.time_range.start)


def _count(evs, name):
    return sum(e.name == name for e in evs)


@pytest.mark.parametrize("num_iter", [4, 8])
def test_train_spans_follow_chunks_and_evals(num_iter):
    """train(n, val_iter=n/2, ls_refresh_iter=n/2) runs two chunks, an
    eval before them and one after each, and a list and an LS refresh
    after each: the spans count those, the same for 4 sweeps as for 8,
    each a child of `smoe.fit.train`."""
    every = num_iter // 2
    s = Smoe(_toy(16), kernels_per_dim=[4], device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.train(num_iter, val_iter=every, ls_refresh_iter=every)
    evs = _spans(prof)
    want = {"smoe.fit.train": 1, "smoe.fit.chunk": 2, "smoe.fit.eval": 3,
            "smoe.fit.update_kernel_list": 2, "smoe.fit.ls_refresh": 2}
    assert {e.name: _count(evs, e.name) for e in evs} == want
    train = next(e for e in evs if e.name == "smoe.fit.train")
    for e in evs:
        if e is not train:
            assert e.cpu_parent is not None \
                and e.cpu_parent.name == "smoe.fit.train", e.name
            assert train.time_range.start <= e.time_range.start \
                <= e.time_range.end <= train.time_range.end
    # the phase the benchmark reads: one a chunk, as before the spans
    assert s.phase_timer.as_dict()["train_sweeps"]["count"] == 2


def test_spans_are_no_user_annotations():
    """A span is recorded as an operator's range: kineto draws no second
    range of its name over the device work it launches, so the host's
    events hold each span once."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("smoe.a"):
            torch.ones(4).sum()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "smoe.a"]
    assert len(evs) == 1 and not evs[0].is_user_annotation()


def test_decode_spans_nest_in_the_request():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = decode_bitstream(FIXTURE, device="cpu")
    assert isinstance(img, np.ndarray)
    evs = _spans(prof)
    nbrs = [e for e in evs if e.name == "smoe.decode.neighbours"]
    evs = [e for e in evs if e.name != "smoe.decode.neighbours"]
    assert [e.name for e in evs] == ["smoe.decode", "smoe.decode.range_decode",
                                     "smoe.decode.rescale",
                                     "smoe.decode.to_host"]
    for e in evs[1:]:
        assert e.cpu_parent is not None and e.cpu_parent.name == "smoe.decode"
    # the neighbour graph, then one inversion a param in "nbr" mode, each
    # inside the range decode
    modes = read_header(FIXTURE)["modes"].values()
    assert len(nbrs) == 1 + sum(m == "nbr" for m in modes)
    for e in nbrs:
        assert e.cpu_parent is not None \
            and e.cpu_parent.name == "smoe.decode.range_decode"


COPY_SPANS = ("smoe.decode.wait", "smoe.decode.copy_pinned",
              "smoe.decode.copy_pageable")


@pytest.mark.parametrize("reference", [False, True])
def test_cpu_decode_records_no_wait_or_copy(reference):
    """On the CPU the image is the decode's own tensor: no wait for a
    stream and no copy, so neither span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_bitstream(FIXTURE, device="cpu", reference=reference)
    names = [e.name for e in _spans(prof)]
    assert "smoe.decode.to_host" in names
    assert not set(names) & set(COPY_SPANS)


def test_card_decode_waits_then_copies_inside_to_host():
    """On the card `smoe.decode.to_host` holds the wait for the decode's
    stream, then one copy to page-locked memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = decode_bitstream(FIXTURE, device="cuda")
    assert torch.from_numpy(img).is_pinned()
    evs = _spans(prof)
    inner = [e for e in evs if e.name in COPY_SPANS]
    assert [e.name for e in inner] == ["smoe.decode.wait",
                                       "smoe.decode.copy_pinned"]
    for e in inner:
        parent = e.cpu_parent
        assert parent is not None and parent.name == "smoe.decode.to_host"
        assert parent.cpu_parent is not None \
            and parent.cpu_parent.name == "smoe.decode"
        assert parent.time_range.start <= e.time_range.start \
            <= e.time_range.end <= parent.time_range.end


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """With no profiler running a span never reaches the profiler's record
    of a range, and it is one shared context; under a profiler it is that
    record."""
    def refuse(name):
        raise AssertionError(f"a record of {name!r}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert span("smoe.a") is span("smoe.b")
    with span("smoe.a"):
        pass
    decode_bitstream(FIXTURE, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="smoe.a"):
            span("smoe.a")


def _video_trainer():
    """A dual-model fit of a 12 x 12 x 4 panned noise clip with its
    affines, one sweep trained."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.2, 0.8, (12, 12, 3)).astype(np.float32)
    vid = np.stack([np.roll(base, i, axis=1) for i in range(4)], axis=2)
    affines = np.zeros((4, 2, 3), np.float32)
    affines[:, 0, 0] = affines[:, 1, 1] = 1.0
    affines[:, 0, 2] = -np.arange(4)
    s = Smoe(vid, kernels_per_dim=[2, 2, 2], affines=affines,
             in_graph_ukl=True, device="cpu")
    s.run_batched_chunk(1)
    return s


@pytest.mark.parametrize("slabs", [1, 2])
def test_reseed_span_once_a_call(slabs):
    """One `smoe.fit.reseed` a reseeded slab, enclosing the list refresh
    and the eval that the reseed's draw reads."""
    s = _video_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for kk in range(slabs):
            s.reseed_time_slab(kk, rng=kk)
    evs = _spans(prof)
    assert _count(evs, "smoe.fit.reseed") == slabs
    inner = [e for e in evs if e.name in ("smoe.fit.update_kernel_list",
                                          "smoe.fit.eval")]
    assert len(inner) >= slabs
    for e in inner:
        assert e.cpu_parent is not None \
            and e.cpu_parent.name == "smoe.fit.reseed", e.name


def test_reseed_records_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record of {name!r}")

    s = _video_trainer()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    rows = s.reseed_time_slab(0, rng=0)
    assert len(rows) == 4
