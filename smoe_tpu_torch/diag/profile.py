"""Tracing and named wall-clock phases for the fit loop (from
smoe_tpu/diag/profile.py).

  * `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
    where there is a card, CUDA activity) that writes a Chrome trace of
    everything inside, the counterpart of the JAX package's jax.profiler
    trace (the fit CLI's --profile_dir);
  * `span(name)`: a named range of the program, recorded by whatever
    `torch.profiler` session is running (so on the clock of its device
    trace, in its event list, and on the host's track of `trace`'s Chrome
    trace) and nothing without one.  A span's parent is the innermost
    span around it on its thread.  The program's spans, each where its
    work happens:
    `smoe.fit.train` (`Smoe.train`) around `smoe.fit.chunk`
    (`run_batched_chunk`, its one host pull included), `smoe.fit.eval`
    (`run_batched`'s evaluation), `smoe.fit.update_kernel_list`,
    `smoe.fit.ls_refresh` (`ls_init_experts`), `smoe.fit.reseed`
    (`reseed_time_slab`: the reconstruction it pulls, the error-
    proportional draw, the list refresh and the re-initialised experts);
    `smoe.graph.warm_up` (the eager first run of a program's key, as
    before each capture and in each `decode_bitstream` call's one decode)
    and `smoe.graph.capture` (fit/graph.py);
    `smoe.decode` (`codec.serve.decode_bitstream`) around
    `smoe.decode.range_decode` and `smoe.decode.rescale` (`read_model`)
    and `smoe.decode.to_host` (the wait for the card and the copy of the
    image; on the card around `smoe.decode.wait`, the wait for the
    decode's stream, and `smoe.decode.copy_pinned` or
    `smoe.decode.copy_pageable`, the copy by the host memory it went to,
    `codec.serve.to_host`); `smoe.decode.neighbours` (`codec.bitstream`'s
    readers: the "nbr" mode's neighbour graph and its inversion, inside
    the range decode).  None is opened inside a captured region or once a sweep, so
    their number grows with chunks, evals and requests;
  * `PhaseTimer`: what `Smoe.train()` uses.  It reads the host clock, so a
    phase that launches work on the card measures its enqueue plus
    whatever host syncs the phase makes (the trainer pulls its metrics once
    per chunk, which waits for the card).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator

import torch
from torch._C._autograd import _profiler_enabled

# one context that does nothing, shared by every span taken while no
# profiler runs
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block with torch.profiler and write its Chrome
    trace to log_dir/trace.json."""
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str) -> ContextManager:
    """A range named `name` in the running profiler session's trace, or,
    with no profiler running, a shared context that does nothing (one
    check of the profiler's state).

    The range is an operator's record (`RecordFunctionFast`, as the
    profiler records an aten op), not `torch.profiler.record_function`'s
    user annotation: kineto draws a user annotation a second time, of the
    same name, over the device work it launched, which a reader of the
    host's events cannot tell from the range itself."""
    if not _profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("sweep"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_s": round(self.totals[k] / max(self.counts[k], 1),
                                    6)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        lines = [f"{'phase':<16}{'total s':>10}{'count':>8}{'mean s':>12}"]
        for k, v in self.as_dict().items():
            lines.append(f"{k:<16}{v['total_s']:>10.3f}{v['count']:>8}"
                         f"{v['mean_s']:>12.6f}")
        out = "\n".join(lines)
        print(out)
        return out
