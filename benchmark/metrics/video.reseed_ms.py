"""video.reseed_ms: the program's `smoe.fit.reseed` spans (`Smoe.
reseed_time_slab`: the pull of the reconstruction, the error-proportional
draw, the list refresh and the re-initialised experts) in the traced
slice of the set-up's last slab, its reseed and LS refit, in ms."""

from yardstick import spans as S


def read(m):
    sl = m.get("reseed_slice")
    rs = S.found({"slice": sl}, "smoe.fit.reseed") if sl else []
    if not rs:
        return None
    return S.seconds(rs) * 1e3
