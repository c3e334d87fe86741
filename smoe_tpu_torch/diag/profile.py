"""Tracing and named wall-clock phases for the fit loop (from
smoe_tpu/diag/profile.py).

  * `trace(log_dir)`: a context manager around `torch.profiler` (CPU and,
    where there is a card, CUDA activity) that writes a Chrome trace of
    everything inside, the counterpart of the JAX package's jax.profiler
    trace (the fit CLI's --profile_dir);
  * `PhaseTimer`: what `Smoe.train()` uses.  It reads the host clock, so a
    phase that launches work on the card measures its enqueue plus
    whatever host syncs the phase makes (the trainer pulls its metrics once
    per chunk, which waits for the card).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block with torch.profiler and write its Chrome
    trace to log_dir/trace.json."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
