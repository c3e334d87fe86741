"""fit.loop_share: the share of the window that `Smoe.train` spends outside
its chunks (evals, list and LS refreshes, snapshots): 1 - the trainer's
"train_sweeps" phase over the window, in %."""


def read(m):
    if "chunk_s" not in m:
        return None
    return 100.0 * (1.0 - m["chunk_s"] / m["window_s"])
