"""CUDA graphs of the trainer's sweeps: the port's counterpart of the JAX
trainer's one compiled program per chunk (`jax.jit` of its `lax.scan` over
sweeps, smoe_tpu/fit/trainer.py:415-425, 675-683, 915-927).

On the card a chunk runs its first sweep eagerly on a side stream (the
warm-up a capture needs: the kernel libraries load, the gradients and
Adam's state come to exist outside the graph), captures one sweep into
the memory pool that the trainer's graphs share, and replays it for the
rest of the chunk. A graph reads and writes fixed addresses and bakes in
every Python value its sweep took, so the trainer keys its graphs by
those values and by the address, shape, stride and dtype of every tensor
the sweep reads or writes (`tensor_key`): a rebinding changes the key,
and the next chunk captures anew. The captured sweep keeps no tensor of
the pool alive after it, so graphs of one pool may replay in any order,
and each capture reuses what the others freed.

`eager()` runs the same sweeps eagerly on the card: the witness a graph is
held to bit for bit, the counterpart of `jax.disable_jit()`.  CPU tensors
never take a graph.

The JAX package's other compiled programs (its eval sweeps, the LS
refresh's accumulation, solves and line search, the serving decode) are
`Programs`: a keyed cache whose first call of a key runs eagerly, whose
second captures and replays, and whose later calls replay, each program
writing its outputs into buffers that live as long as its key.

The K1 and K2 wrappers count their launches in Python, which a replay does
not run: a capture takes back what its sweep counted and keeps it, and
every replay adds it, so the counters go on counting launches on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, Tuple

import torch

from smoe_tpu_torch.diag.profile import span
from smoe_tpu_torch.kernels import gate_expert as ge

_EAGER = [0]       # depth of eager() blocks
_SIDE = [None]     # the process's side stream (`side_stream`)


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


def side_stream():
    """The one side stream every warm-up and capture of the process runs
    on (torch.cuda.graph's default capture stream): the caching allocator
    reuses a freed block only on the stream that allocated it, so one
    stream lets each capture into a pool reuse what the pool's earlier
    captures freed (the pool then holds its largest capture's temporaries,
    not their sum), and keeps one cache of the warm-ups' temporaries, not
    one a stream."""
    if _SIDE[0] is None:
        _SIDE[0] = torch.cuda.Stream()
    return _SIDE[0]


def warm_up(fn: Callable[[], None]) -> None:
    """fn() eagerly on the side stream, ordered after and before the
    current stream's work (torch.cuda.graph's warm-up), in the span
    `smoe.graph.warm_up`."""
    with span("smoe.graph.warm_up"):
        side = side_stream()
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
    side = side_stream()
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
    counts the K1 and K2 launches it holds (`held`; `held_bf16`, those of
    the bf16 instances among them).  `capture_s`: the host seconds the
    capture took, in the span `smoe.graph.capture`."""

    def __init__(self, fn: Callable[[], None], pool,
                 generators: Iterable[torch.Generator] = ()):
        t0 = time.perf_counter()
        with span("smoe.graph.capture"):
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            before, before_bf16 = ge.launch_counts(), ge.bf16_launch_counts()
            _capture(self.graph, fn, pool)
        self.capture_s = time.perf_counter() - t0
        self.held: Tuple[int, int] = tuple(
            a - b for a, b in zip(ge.launch_counts(), before))
        self.held_bf16: Tuple[int, int] = tuple(
            a - b for a, b in zip(ge.bf16_launch_counts(), before_bf16))
        ge.add_launches(*(-n for n in self.held + self.held_bf16))

    def replay(self) -> None:
        self.graph.replay()
        ge.add_launches(*self.held, *self.held_bf16)


class Programs:
    """Keyed programs on the card that share one graph pool.

    `run(key, fn)`: fn() returns a tuple of tensors.  The first call of a
    key runs fn eagerly on a side stream (the warm-up a capture needs) and
    keeps clones of its outputs as the key's buffers; the second captures
    fn writing its outputs into those buffers and replays the capture;
    later calls replay.  Returns the buffers, which the next call of the
    key overwrites: a caller clones what it keeps.  So a program that reads
    another's outputs (the LS refresh's solve reads its accumulation's)
    reads them at the same addresses from the first call on, and its key
    holds.  As for a sweep, the key must hold every value fn bakes in and
    the `tensor_key` of every tensor it reads; an input that changes
    between calls is copied into a tensor that lives as long as the key,
    never rebound.

    `pool`: the graph pool the captures go into (made at the first
    capture unless set: the trainer sets the one its sweeps go into).  A
    pool lives as long as a graph that uses it, so it belongs to the
    owner of the graphs, never to the process."""

    def __init__(self):
        self.graphs: Dict[tuple, SweepGraph] = {}
        self.buffers: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self.pool = None

    def run(self, key: tuple, fn: Callable[[], tuple]):
        graph = self.graphs.get(key)
        if graph is None:
            bufs = self.buffers.get(key)
            if bufs is None:
                out = []
                warm_up(lambda: out.extend(fn()))
                self.buffers[key] = tuple(t.clone() for t in out)
                return self.buffers[key]

            def body():
                for b, t in zip(bufs, fn()):
                    b.copy_(t)

            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = self.graphs[key] = SweepGraph(body, self.pool)
        graph.replay()
        return self.buffers[key]

    def capture_s(self) -> float:
        """Host seconds the captures of this cache took."""
        return sum(g.capture_s for g in self.graphs.values())
