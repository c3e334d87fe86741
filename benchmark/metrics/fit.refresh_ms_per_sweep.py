"""fit.refresh_ms_per_sweep: the program's `smoe.fit.update_kernel_list`
and `smoe.fit.ls_refresh` spans (the list and LS refreshes, in the loop or
in a chunk) in the traced call, over its sweeps."""

from yardstick import spans as S


def read(m):
    rf = S.found(m, "smoe.fit.update_kernel_list", "smoe.fit.ls_refresh")
    if not rf:
        return None
    return S.seconds(rf) / m["slice_sweeps"] * 1e3
