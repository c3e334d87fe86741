"""decode.copy_ms: the program's copies of the decoded image to host
memory, `smoe.decode.copy_pinned` and `smoe.decode.copy_pageable` spans
(each the copy and its completion, inside `smoe.decode.to_host`), in the
traced window, ms a request."""

from yardstick import spans as S


def read(m):
    cp = S.found(m, "smoe.decode.copy_pinned", "smoe.decode.copy_pageable")
    if not cp:
        return None
    return S.seconds(cp) / m["requests"] * 1e3
