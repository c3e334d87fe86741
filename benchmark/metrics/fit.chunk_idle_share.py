"""fit.chunk_idle_share: 1 - the device activity inside the program's
`smoe.fit.chunk` spans (its union, clipped to them) over their summed
time, in %: the device's idle share within the graphed sweeps, apart from
the loop's own."""

from yardstick import spans as S


def read(m):
    ch = S.found(m, "smoe.fit.chunk")
    if not ch:
        return None
    return 100.0 * (1.0 - S.busy_within_s(m["slice"], ch) / S.seconds(ch))
