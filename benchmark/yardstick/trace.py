"""A bounded profiler slice, kept in memory and reduced to a summary.

`profiled(fn, device)` runs fn() under torch.profiler (CPU and, on a card,
CUDA activity through CUPTI, which records the kernels a CUDA graph
replays as well) and returns a `Slice`: every device activity (kernels,
copies, sets) as (name, start, end) in seconds, the host's activities,
and the wall-clock window of the slice.  Nothing is written to disk.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

Interval = Tuple[str, float, float]


class Slice(NamedTuple):
    device: List[Interval]       # device activities, sorted by start
    host: List[Interval]         # host activities (ops, runtime calls)
    window_s: float              # wall seconds of the slice


def _events(prof):
    """(name, is_device, start_s, end_s) of every activity the profiler
    kept, read from kineto's event list (fast at 10^5-10^6 events); the
    FunctionEvent list where that is not available."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            s = e.start_ns() * 1e-9
            out.append((e.name(), dev and not _annotation(e), s,
                        s + e.duration_ns() * 1e-9))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((e.name, dev and not _annotation(e),
                    e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out


def _annotation(e) -> bool:
    """Whether a device event is the shadow of a host `record_function`
    range (kineto's GPU user annotation), which spans device work but is
    none itself."""
    test = getattr(e, "is_user_annotation", None)
    if callable(test):
        try:
            if test():
                return True
        except (RuntimeError, TypeError):
            pass
    name = e.name() if callable(e.name) else e.name
    return name.startswith(ANNOTATIONS)


# the names of the benchmark's own ranges around its calls into the program
ANNOTATIONS = ("bench.",)


def profiled(fn: Callable[[], None], device) -> Slice:
    """Run fn() under the profiler; the slice's window is the host clock
    around fn() and a synchronize after it."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    evs = _events(prof)
    dev = sorted(((n, s, e) for n, d, s, e in evs if d), key=lambda x: x[1])
    host = [(n, s, e) for n, d, s, e in evs if not d]
    return Slice(dev, host, window)


def union_s(intervals: List[Interval]) -> float:
    """Seconds covered by at least one interval."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def matching(sl: Slice, names) -> List[Interval]:
    """The device activities whose name contains one of `names`."""
    return [iv for iv in sl.device if any(n in iv[0] for n in names)]


def busy_s(sl: Slice) -> float:
    return union_s(sl.device)


def top_ops(sl: Slice, n: int = 10) -> List[list]:
    """[[name, seconds]] of the device operations that took most time."""
    tot = {}
    for name, s, e in sl.device:
        key = name[:120]
        tot[key] = tot.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(sl: Slice, n: int = 10, min_s: float = 20e-6) -> List[list]:
    """[[what the host was doing, seconds]] of the longest gaps between
    device activities, each named by the innermost host activity that
    spans the gap's middle ("no host activity" where none does)."""
    merged = []
    for _, s, e in sorted(sl.device, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] - merged[i][1] >= min_s]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        cover: Optional[Interval] = None
        for iv in sl.host:
            if iv[1] <= mid <= iv[2] and (cover is None or
                                          iv[2] - iv[1] < cover[2] - cover[1]):
                cover = iv
        out.append([cover[0][:120] if cover else "no host activity", b - a])
    return out
