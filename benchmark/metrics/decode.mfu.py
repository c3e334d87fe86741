"""decode.mfu: the operations the traced window's K1 launches need
(`yardstick.work`) over its wall time and the fp32 peak, in %."""

from yardstick import readers as rd
from yardstick import work as W


def read(m):
    if "slice" not in m or "decode_work" not in m:
        return None
    if rd.device_s(m, rd.K1_NAMES) == 0:
        return None
    return 100.0 * rd.decode_launch_work(m)[1] / (m["slice"].window_s
                                                  * W.FP32_PEAK_FLOPS)
