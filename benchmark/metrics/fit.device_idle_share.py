"""fit.device_idle_share: 1 - the union of device activity over the traced
call's wall time, in %."""

from yardstick import trace as tr


def read(m):
    if "slice" not in m or not m["slice"].device:
        return None
    return 100.0 * (1.0 - tr.busy_s(m["slice"]) / m["slice"].window_s)
