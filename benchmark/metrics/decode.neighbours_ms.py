"""decode.neighbours_ms: the program's `smoe.decode.neighbours` spans
(`read_bitstream`'s "nbr" mode: the causal neighbour graph of the decoded
positions and the residuals' inversion, inside the range decode) in the
traced window, ms a request."""

from yardstick import spans as S


def read(m):
    nb = S.found(m, "smoe.decode.neighbours")
    if not nb:
        return None
    return S.seconds(nb) / m["requests"] * 1e3
