"""The reader of the parse layer's `smoe.decode.neighbours` spans
(`decode.neighbours_ms`) on made slices: nothing read where the span is
absent, and the graph builds and inversions of each request, nested in
its range decode, summed and read per request."""

import pytest

import run
from yardstick import trace as tr


def reader():
    return run.load_module(f"{run.HERE}/metrics/decode.neighbours_ms.py",
                           "r_decode_neighbours_ms").read


def ms(a, b):
    return a * 1e-3, b * 1e-3


DEVICE = [("gate_expert_fwd_kernel", *ms(4, 9)),
          ("Memcpy DtoH (Device -> Pageable)", *ms(9, 12)),
          ("gate_expert_fwd_kernel", *ms(24, 29)),
          ("Memcpy DtoH (Device -> Pageable)", *ms(29, 32))]


def decode_host(neighbours=True):
    host = []
    for t in (0, 20):
        host += [("smoe.decode", *ms(t, t + 13)),
                 ("smoe.decode.range_decode", *ms(t, t + 3)),
                 ("smoe.decode.rescale", *ms(t + 3, t + 4)),
                 ("smoe.decode.to_host", *ms(t + 7, t + 12.5))]
        if neighbours:
            host += [("smoe.decode.neighbours", *ms(t + 1, t + 1.25)),
                     ("smoe.decode.neighbours", *ms(t + 2, t + 2.5))]
    return host


@pytest.mark.parametrize("m", [
    {"slice": tr.Slice(DEVICE, decode_host(False), 0.04), "requests": 2},
    {"slice": tr.Slice([], decode_host(), 0.04), "requests": 2},
    {"requests": 2}],
    ids=["parent_spans", "no_device", "no_trace"])
def test_reads_nothing_without_its_span(m):
    """As at a program whose parse opens no such span, on the CPU (no
    device activity), and untraced."""
    assert reader()(m) is None


def test_reads_its_spans_per_request():
    """A graph build and an inversion in each of two requests' range
    decodes: 0.25 + 0.5 ms a request."""
    m = {"slice": tr.Slice(DEVICE, decode_host(), 0.04), "requests": 2}
    assert reader()(m) == pytest.approx(0.75)
