"""The readers of the decoder's copy of the image to the host
(`decode.copy_ms`, `decode.pinned_share`) on made slices: their
arithmetic over page-locked and pageable copies, and nothing read where
the copy spans are absent."""

import pytest

import run
from yardstick import trace as tr

COPY = ("decode.copy_ms", "decode.pinned_share")


def reader(name):
    return run.load_module(f"{run.HERE}/metrics/{name}.py",
                           "r_" + name.replace(".", "_")).read


def ms(a, b):
    return a * 1e-3, b * 1e-3


# two requests (times in ms): the first copies to page-locked memory, the
# second, whose page-locked allocation failed, to pageable memory
DEVICE = [("gate_expert_fwd_kernel", *ms(4, 9)),
          ("Memcpy DtoH (Device -> Pinned)", *ms(9, 11)),
          ("gate_expert_fwd_kernel", *ms(24, 29)),
          ("Memcpy DtoH (Device -> Pageable)", *ms(29, 35))]
HOST = [("smoe.decode", *ms(0, 12)),
        ("smoe.decode.to_host", *ms(7, 11.5)),
        ("smoe.decode.wait", *ms(7, 9)),
        ("smoe.decode.copy_pinned", *ms(9, 11.5)),
        ("smoe.decode", *ms(20, 36)),
        ("smoe.decode.to_host", *ms(27, 35.5)),
        ("smoe.decode.wait", *ms(27, 29)),
        ("smoe.decode.copy_pageable", *ms(29, 35.5))]


def decode_m(host=HOST, device=DEVICE):
    return {"slice": tr.Slice(device, host, 0.04), "requests": 2}


def test_copy_readers_arithmetic():
    m = decode_m()
    assert reader("decode.copy_ms")(m) == pytest.approx((2.5 + 6.5) / 2)
    assert reader("decode.pinned_share")(m) == pytest.approx(50.0)
    assert reader("decode.to_host_ms")(m) == pytest.approx((4.5 + 8.5) / 2)


def test_every_copy_page_locked():
    pinned = [iv for iv in HOST if iv[0] != "smoe.decode.copy_pageable"]
    m = decode_m(pinned)
    assert reader("decode.pinned_share")(m) == pytest.approx(100.0)
    assert reader("decode.copy_ms")(m) == pytest.approx(2.5 / 2)


@pytest.mark.parametrize("name", COPY)
def test_readers_read_nothing_without_their_spans(name):
    """As at a program whose `smoe.decode.to_host` holds no copy span,
    without any program span, on the CPU (no device), and untraced."""
    parent = [iv for iv in HOST
              if not iv[0].startswith(("smoe.decode.wait",
                                       "smoe.decode.copy_"))]
    plain = [iv for iv in HOST if not iv[0].startswith("smoe.")]
    assert reader(name)(decode_m(parent)) is None
    assert reader(name)(decode_m(plain)) is None
    assert reader(name)(decode_m(device=[])) is None
    assert reader(name)({"requests": 2}) is None
