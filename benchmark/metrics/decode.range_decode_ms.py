"""decode.range_decode_ms: the program's `smoe.decode.range_decode` spans
(`read_bitstream`, the entropy decode) in the traced window, ms a
request."""

from yardstick import spans as S


def read(m):
    rd = S.found(m, "smoe.decode.range_decode")
    if not rd:
        return None
    return S.seconds(rd) / m["requests"] * 1e3
