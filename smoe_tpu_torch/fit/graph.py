"""CUDA graphs of the trainer's sweeps: the port's counterpart of the JAX
trainer's one compiled program per chunk (`jax.jit` of its `lax.scan` over
sweeps, smoe_tpu/fit/trainer.py:415-425, 675-683, 915-927).

On the card a chunk runs its first sweep eagerly on a side stream (the
warm-up a capture needs: the kernel libraries load, the gradients and
Adam's state come to exist outside the graph), captures one sweep into a
memory pool that the trainer's graphs share, and replays it for the rest
of the chunk.  A graph reads and writes fixed addresses and bakes in every
Python value its sweep took, so the trainer keys its graphs by those
values and by the address, shape, stride and dtype of every tensor the
sweep reads or writes (`tensor_key`): a rebinding changes the key, and the
next chunk captures anew.  The captured sweep keeps no tensor of the pool
alive after it, so graphs of one pool may replay in any order.

`eager()` runs the same sweeps eagerly on the card: the witness a graph is
held to bit for bit, the counterpart of `jax.disable_jit()`.  CPU tensors
never take a graph.

The K1 and K2 wrappers count their launches in Python, which a replay does
not run: a capture takes back what its sweep counted and keeps it, and
every replay adds it, so the counters go on counting launches on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, Tuple

import torch

from smoe_tpu_torch.kernels import gate_expert as ge

_EAGER = [0]       # depth of eager() blocks


@contextlib.contextmanager
def eager():
    """Within the block, sweeps on the card run eagerly (no capture, no
    replay); blocks nest."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def graphed(device) -> bool:
    """Whether sweeps on `device` are captured: on a CUDA device, outside
    `eager()`."""
    return torch.device(device).type == "cuda" and not _EAGER[0]


def tensor_key(t: torch.Tensor):
    """What a graph bakes in of a tensor it reads or writes: its address and
    layout (None for an absent tensor)."""
    if t is None:
        return None
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


def warm_up(fn: Callable[[], None]) -> None:
    """fn() eagerly on a side stream, ordered after and before the current
    stream's work (torch.cuda.graph's warm-up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)


def _capture(graph, fn: Callable[[], None], pool) -> None:
    """Record fn() into `graph` on a side stream.  A host sync in fn raises
    at the op that syncs (sync debug mode "error"), where the capture
    itself would fail with an error that names no op.  Unlike
    torch.cuda.graph, it does not synchronize the device first, so a chunk
    that captures still syncs with the host once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool)
        try:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)


class SweepGraph:
    """fn() captured once into `pool` (a `torch.cuda.graph_pool_handle()`),
    with the generators it draws from registered, so that each replay
    draws what the next eager call would; `replay()` runs it again and
    counts the K1 and K2 launches it holds (`held`).  `capture_s`: the
    host seconds the capture took."""

    def __init__(self, fn: Callable[[], None], pool,
                 generators: Iterable[torch.Generator] = ()):
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = ge.launch_counts()
        _capture(self.graph, fn, pool)
        self.capture_s = time.perf_counter() - t0
        self.held: Tuple[int, int] = tuple(
            a - b for a, b in zip(ge.launch_counts(), before))
        ge.add_launches(*(-n for n in self.held))

    def replay(self) -> None:
        self.graph.replay()
        ge.add_launches(*self.held)
