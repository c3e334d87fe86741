"""The program's own spans in a traced slice: the `smoe.*` ranges that
`smoe_tpu_torch.diag.profile.span` opens, as the profiler kept them among
the slice's host activities, on the clock of its device trace.  The
program records each as an operator's range, once: kineto draws no user
annotation of it over the device's track."""

from __future__ import annotations

from typing import List, Tuple

from yardstick import trace as tr

Range = Tuple[float, float]


def spans(sl: tr.Slice, *names: str) -> List[Range]:
    """(start, end) in seconds of the host ranges named one of `names`,
    sorted by start."""
    return sorted((s, e) for n, s, e in sl.host if n in names)


def found(m: dict, *names: str) -> List[Range]:
    """`spans` of the run's traced slice; none where the run traced
    nothing or its slice holds no device activity (the CPU, where the
    benchmark's tests run the cells)."""
    if "slice" not in m or not m["slice"].device:
        return []
    return spans(m["slice"], *names)


def seconds(ranges: List[Range]) -> float:
    return sum(e - s for s, e in ranges)


def busy_within_s(sl: tr.Slice, ranges: List[Range]) -> float:
    """Seconds of device activity (their union) inside `ranges`, which do
    not overlap one another."""
    busy = 0.0
    for a, b in ranges:
        busy += tr.union_s([(n, max(s, a), min(e, b)) for n, s, e in sl.device
                            if s < b and e > a])
    return busy
