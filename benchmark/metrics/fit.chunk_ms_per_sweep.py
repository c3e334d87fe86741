"""fit.chunk_ms_per_sweep: the trainer's "train_sweeps" phase (host clock
around each chunk, which ends in its one pull) over the window's sweeps."""


def read(m):
    if "chunk_s" not in m:
        return None
    return m["chunk_s"] / m["sweeps"] * 1e3
