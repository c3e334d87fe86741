"""decode.k1_roofline: the least time of the traced window's K1 launches
(`yardstick.work`, every pixel and coded kernel, the cull counted by the
reference) over their device time, in %."""

from yardstick import readers as rd


def read(m):
    if "slice" not in m or "decode_work" not in m:
        return None
    t = rd.device_s(m, rd.K1_NAMES)
    if t == 0:
        return None
    return 100.0 * rd.decode_launch_work(m)[0] / t
