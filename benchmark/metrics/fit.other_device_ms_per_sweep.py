"""fit.other_device_ms_per_sweep: device time of every operation of the
traced call other than K1 and K2, over its sweeps."""

from yardstick import readers as rd


def read(m):
    if "slice" not in m or not m["slice"].device:
        return None
    total = sum(e - s for _, s, e in m["slice"].device)
    kk = rd.device_s(m, rd.K1_NAMES + rd.K2_NAMES)
    if kk == 0:
        return None
    return (total - kk) / m["slice_sweeps"] * 1e3
