"""fit.k1_roofline: the least time of the traced call's K1 launches
(`yardstick.work`) over their device time, in %."""

from yardstick import readers as rd


def read(m):
    if "slice" not in m or "fit_work" not in m:
        return None
    t = rd.device_s(m, rd.K1_NAMES)
    if t == 0:
        return None
    return 100.0 * rd.fit_launch_work(m, "k1")[0] / t
