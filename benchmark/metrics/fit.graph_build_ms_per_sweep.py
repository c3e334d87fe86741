"""fit.graph_build_ms_per_sweep: the program's `smoe.graph.warm_up` and
`smoe.graph.capture` spans (a graph built: its eager first run and its
capture) in the traced call, over its sweeps; 0 where the call built no
graph.  Nothing where the call has no `smoe.fit.train` span."""

from yardstick import spans as S


def read(m):
    if not S.found(m, "smoe.fit.train"):
        return None
    gb = S.found(m, "smoe.graph.warm_up", "smoe.graph.capture")
    return S.seconds(gb) / m["slice_sweeps"] * 1e3
