"""The card a run measured on: a copy of `smoe_tpu_torch/bench/common.py`'s
`card_fields` and its synchronising host clock."""

from __future__ import annotations

import subprocess
import time

import torch


def power_limit_w(index: int = 0):
    """Card `index`'s power limit in W as nvidia-smi reads it, or None where
    nvidia-smi gives none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}",
                              "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def card_fields(device) -> dict:
    """{"card", "power_limit_w"}: torch's name of the card and its power
    limit; "cpu" and None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"card": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"card": torch.cuda.get_device_name(index),
            "power_limit_w": power_limit_w(index)}


def clock(device) -> float:
    """time.perf_counter() once the card is idle."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()
