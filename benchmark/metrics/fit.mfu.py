"""fit.mfu: the operations the traced call's K1 and K2 launches need
(`yardstick.work`) over its wall time and the fp32 peak, in %."""

from yardstick import readers as rd
from yardstick import work as W


def read(m):
    if "slice" not in m or "fit_work" not in m:
        return None
    if rd.device_s(m, rd.K1_NAMES) == 0:
        return None
    flops = rd.fit_launch_work(m, "k1")[1] + rd.fit_launch_work(m, "k2")[1]
    return 100.0 * flops / (m["slice"].window_s * W.FP32_PEAK_FLOPS)
