"""Multi-process initialization and rank-0 artifacts (from
smoe_tpu/parallel/multihost.py:29-70).

One process per card: `initialize` joins the torch.distributed world, a
`DeviceMesh` built over it (parallel/sharded.py:make_mesh) gives
`Smoe(mesh=...)` its 'b' and 'k' groups, and the gradient psum keeps every
process's replicated state identical each sweep.

Checkpoints are written by rank 0 only; on resume every process restores
the same file (params, Adam moments, kernel lists and the iteration count
are all in it, `Smoe.checkpoint`), so the fleet restarts in lockstep.
Under a mesh `Smoe.checkpoint` gathers the kernel rows on every rank and
writes on rank 0, so every rank calls it.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective may wait for a rank before the world fails
TIMEOUT_S = 600.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> bool:
    """Join the torch.distributed world: NCCL when the run's device is
    CUDA, gloo on the CPU.  Call before any collective.

    No-op (returns False) for a one-process run: no coordinator given and
    num_processes absent or 1 (multihost.py:40-41).  With no coordinator
    but num_processes > 1, torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) wires the world, as jax's cluster
    auto-detection does (multihost.py:36-38)."""
    if coordinator_address is None and (num_processes or 1) == 1:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {"backend": backend, "timeout": timedelta(seconds=TIMEOUT_S)}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
        kw["world_size"] = int(num_processes if num_processes is not None
                               else os.environ["WORLD_SIZE"])
        kw["rank"] = int(process_id if process_id is not None
                         else os.environ["RANK"])
    if backend == "nccl":
        # each process on its own card: the device's index, else torchrun's
        # LOCAL_RANK
        idx = torch.device(device).index
        torch.cuda.set_device(idx if idx is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(**kw)
    return True


def primary() -> bool:
    """True on the artifact-owning process (rank 0), and in a run that
    joined no world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(smoe, path: str) -> bool:
    """Rank-0 full-state checkpoint.  Returns True if this process wrote.
    Under a mesh every rank joins the row gathers of `Smoe.checkpoint`,
    which writes on rank 0 only."""
    if getattr(smoe, "mesh", None) is not None:
        smoe.checkpoint(path)
        return primary()
    if not primary():
        return False
    smoe.checkpoint(path)
    return True


def save_model_primary(save_fn, *args, **kwargs) -> bool:
    """Run a host-side save callable on rank 0 only."""
    if not primary():
        return False
    save_fn(*args, **kwargs)
    return True
