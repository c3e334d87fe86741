"""The readers of the program's spans (`yardstick.spans` and the
`program_span` metrics that read `smoe.*` ranges) on made slices: their
arithmetic, nothing read where the spans are absent, and no range among
the device activities."""

import pytest
import torch

import run
from yardstick import spans as S, trace as tr

FIT = ("fit.eval_ms_per_sweep", "fit.refresh_ms_per_sweep",
       "fit.graph_build_ms_per_sweep", "fit.chunk_idle_share")
DECODE = ("decode.range_decode_ms", "decode.rescale_ms", "decode.to_host_ms")


def reader(name):
    return run.load_module(f"{run.HERE}/metrics/{name}.py",
                           "r_" + name.replace(".", "_")).read


def ms(a, b):
    return a * 1e-3, b * 1e-3


# a traced call of 10 sweeps (times in ms): two chunks, the first building
# a graph; an eval, a list refresh and an LS refresh between them
DEVICE = [("k", *ms(10, 12)), ("k", *ms(13, 15)), ("k", *ms(30, 31)),
          ("k", *ms(40, 50)), ("k", *ms(52, 55))]
HOST = [("smoe.fit.train", *ms(0, 100)),
        ("smoe.fit.chunk", *ms(5, 20)), ("smoe.graph.warm_up", *ms(6, 8)),
        ("smoe.graph.capture", *ms(8, 9)),
        ("smoe.fit.update_kernel_list", *ms(21, 23)),
        ("smoe.fit.eval", *ms(25, 35)), ("smoe.fit.chunk", *ms(45, 60)),
        ("smoe.fit.ls_refresh", *ms(62, 70)), ("aten::add", *ms(26, 27))]


def fit_m(host=HOST, device=DEVICE):
    return {"slice": tr.Slice(device, host, 0.1), "slice_sweeps": 10}


def test_fit_readers_arithmetic():
    m = fit_m()
    assert reader("fit.eval_ms_per_sweep")(m) == pytest.approx(10 / 10)
    assert reader("fit.refresh_ms_per_sweep")(m) == pytest.approx(
        (2 + 8) / 10)
    assert reader("fit.graph_build_ms_per_sweep")(m) == pytest.approx(
        (2 + 1) / 10)
    # inside the chunks 5-20 and 45-60: 10-12, 13-15, and 40-50 clipped
    # to 45-50, 52-55; 12 of 30 ms busy
    assert reader("fit.chunk_idle_share")(m) == pytest.approx(
        100 * (1 - 12 / 30))


def test_spans_by_name():
    sl = fit_m()["slice"]
    assert S.spans(sl, "smoe.fit.chunk") == [ms(5, 20), ms(45, 60)]
    assert S.spans(sl, "smoe.fit.eval", "smoe.fit.ls_refresh") == [
        ms(25, 35), ms(62, 70)]


def test_no_graph_built_reads_zero():
    host = [iv for iv in HOST if not iv[0].startswith("smoe.graph.")]
    assert reader("fit.graph_build_ms_per_sweep")(fit_m(host)) == 0.0


@pytest.mark.parametrize("name", FIT + DECODE)
def test_readers_read_nothing_without_their_spans(name):
    """As at a program without spans, and on the CPU (no device)."""
    plain = [iv for iv in HOST if not iv[0].startswith("smoe.")]
    m = dict(fit_m(plain), requests=2)
    assert reader(name)(m) is None
    assert reader(name)(dict(fit_m(device=[]), requests=2)) is None
    assert reader(name)({"slice_sweeps": 10, "requests": 2}) is None


def test_decode_readers_arithmetic():
    device = [("gate_expert_fwd_kernel", *ms(4, 9)),
              ("Memcpy DtoH (Device -> Pageable)", *ms(9, 12)),
              ("gate_expert_fwd_kernel", *ms(24, 29)),
              ("Memcpy DtoH (Device -> Pageable)", *ms(29, 32))]
    host = []
    for t in (0, 20):
        host += [("smoe.decode", *ms(t, t + 13)),
                 ("smoe.decode.range_decode", *ms(t, t + 3)),
                 ("smoe.decode.rescale", *ms(t + 3, t + 4)),
                 ("smoe.decode.to_host", *ms(t + 7, t + 12.5))]
    m = {"slice": tr.Slice(device, host, 0.04), "requests": 2}
    assert reader("decode.range_decode_ms")(m) == pytest.approx(3)
    assert reader("decode.rescale_ms")(m) == pytest.approx(1)
    assert reader("decode.to_host_ms")(m) == pytest.approx(5.5)


class _Event:
    """What `trace._events` reads of a kineto event."""

    def __init__(self, name, cuda, annotation, start_ns, dur_ns):
        self._v = (name, cuda, annotation, start_ns, dur_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] \
            else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": res})()


def test_spans_never_count_as_device_activity():
    """A span (an operator's range on the host) lands among the host's
    activities, as would a user annotation's range on the device's track:
    busy_s and top_ops see the kernel alone."""
    evs = tr._events(_Prof([
        _Event("smoe.fit.eval", False, False, 0, 10_000_000),
        _Event("user annotation", True, True, 2_000_000, 3_000_000),
        _Event("gate_expert_fwd_kernel", True, False, 2_000_000,
               3_000_000)]))
    dev = [(n, s, e) for n, d, s, e in evs if d]
    host = [(n, s, e) for n, d, s, e in evs if not d]
    sl = tr.Slice(dev, host, 0.01)
    assert [iv[0] for iv in sl.device] == ["gate_expert_fwd_kernel"]
    assert tr.busy_s(sl) == pytest.approx(3e-3)
    assert [n for n, _ in tr.top_ops(sl)] == ["gate_expert_fwd_kernel"]
    assert S.spans(sl, "smoe.fit.eval") == [(0.0, 0.01)]


def test_a_profiled_slice_keeps_the_programs_spans_on_the_host():
    from smoe_tpu_torch.diag.profile import span

    def work():
        with span("smoe.fit.eval"):
            torch.ones(4).sum()

    sl = tr.profiled(work, "cpu")
    assert not any(n.startswith("smoe.") for n, _, _ in sl.device)
    assert [n for n, _, _ in sl.host if n.startswith("smoe.")] == [
        "smoe.fit.eval"]
