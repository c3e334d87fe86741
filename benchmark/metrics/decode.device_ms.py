"""decode.device_ms: the union of device activity in the traced window
over its requests, ms a request."""

from yardstick import trace as tr


def read(m):
    if "slice" not in m or not m["slice"].device:
        return None
    return tr.busy_s(m["slice"]) / m["requests"] * 1e3
