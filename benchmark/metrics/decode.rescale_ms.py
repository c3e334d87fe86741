"""decode.rescale_ms: the program's `smoe.decode.rescale` spans
(`rescaler`, the dequantization, with the grid of the used kernels) in the
traced window, ms a request."""

from yardstick import spans as S


def read(m):
    rs = S.found(m, "smoe.decode.rescale")
    if not rs:
        return None
    return S.seconds(rs) / m["requests"] * 1e3
