"""decode.pinned_share: of the program's copies of the decoded image to
host memory in the traced window, the share that went to page-locked
memory (`smoe.decode.copy_pinned` among it and
`smoe.decode.copy_pageable`), %: counted, not timed."""

from yardstick import spans as S


def read(m):
    pinned = S.found(m, "smoe.decode.copy_pinned")
    every = S.found(m, "smoe.decode.copy_pinned", "smoe.decode.copy_pageable")
    if not every:
        return None
    return 100.0 * len(pinned) / len(every)
