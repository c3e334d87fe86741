"""fit.eval_ms_per_sweep: the program's `smoe.fit.eval` spans (the evals
`Smoe.train` runs between its chunks, with any graph they build) in the
traced call, over its sweeps."""

from yardstick import spans as S


def read(m):
    ev = S.found(m, "smoe.fit.eval")
    if not ev:
        return None
    return S.seconds(ev) / m["slice_sweeps"] * 1e3
