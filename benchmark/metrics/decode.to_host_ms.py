"""decode.to_host_ms: the program's `smoe.decode.to_host` spans (the
host's wait for the decode on the card and the copy of its image to host
memory) in the traced window, ms a request."""

from yardstick import spans as S


def read(m):
    th = S.found(m, "smoe.decode.to_host")
    if not th:
        return None
    return S.seconds(th) / m["requests"] * 1e3
