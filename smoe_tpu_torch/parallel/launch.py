"""Run a function in a world of N processes on one machine.

    results = run_world("path/to/file.py:fn", 2, workdir, device="cpu")

starts `python -m smoe_tpu_torch.parallel.launch` N times.  Each process
joins a torch.distributed world through a `file://` store in `workdir`
(no TCP port to race for), calls `fn(rank, world, **kwargs)`, pickles its
return value to `workdir/rank<r>.pkl` and leaves the world.  The backend
is gloo, so several ranks may share one card.  A rank that fails or hangs
fails the whole run: the others are killed at `timeout` seconds and the
call raises with each rank's output tail.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(target: str):
    path, name = target.rsplit(":", 1)
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(path))[0], path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    return getattr(mod, name)


def run_world(target: str, world: int, workdir: str, device: str = "cpu",
              timeout: float = 120.0, threads: int = 1, **kwargs):
    """Results of `target` on ranks 0..world-1, in rank order."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "smoe_tpu_torch.parallel.launch",
             target, str(rank), str(world), workdir, device, str(timeout),
             str(threads), json.dumps(kwargs)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while not failed:
            rcs = [p.poll() for p, _ in procs]
            failed = [(r, rc) for r, rc in enumerate(rcs)
                      if rc not in (None, 0)]
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > deadline:
                failed = [(rcs.index(None), "timeout")]
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        tails = []
        for rank in range(world):
            with open(os.path.join(workdir, f"rank{rank}.log")) as fd:
                tails.append(f"--- rank {rank} ---\n{fd.read()[-3000:]}")
        raise RuntimeError(f"world of {world} failed at rank {failed[0][0]} "
                           f"({failed[0][1]}):\n" + "\n".join(tails))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as fd:
            out.append(pickle.load(fd))
    return out


def _worker(argv) -> int:
    p = argparse.ArgumentParser()
    for name in ("target", "rank", "world", "workdir", "device", "timeout",
                 "threads", "kwargs"):
        p.add_argument(name)
    a = p.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(int(a.threads))
    rank, world = int(a.rank), int(a.world)
    if torch.device(a.device).type == "cuda":
        torch.cuda.set_device(torch.device(a.device))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(a.workdir, "store"),
        rank=rank, world_size=world,
        timeout=timedelta(seconds=float(a.timeout)))
    try:
        result = _load(a.target)(rank, world, **json.loads(a.kwargs))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(a.workdir, f"rank{rank}.pkl"), "wb") as fd:
        pickle.dump(result, fd)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
