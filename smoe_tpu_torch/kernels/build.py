"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc`
for Hopper (`sm_90a`) into `kernels/build/lib<name>.so` (git-ignored) at
first use, rebuilt when the source or any `csrc/*.cuh` header it may
include is newer than the library, and loaded with ctypes.  No PyTorch
headers are compiled, so a build takes seconds.
No `--use_fast_math`: the kernels rely on IEEE division and full `expf`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def is_stale(so: str, src: str, src_dir: str = SRC_DIR) -> bool:
    """True when the library `so` is missing or older than `src` or any
    `*.cuh` header in `src_dir` (a header edit must rebuild every library,
    since each may include it)."""
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    deps = [src] + glob.glob(os.path.join(src_dir, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(name: str) -> dict:
    """Compile csrc/<name>.cu unless the library is up to date.

    Returns {"path", "built" (bool), "seconds", "log"}: `log` holds
    nvcc's output, including ptxas' register and shared-memory report.
    """
    src = os.path.join(SRC_DIR, name + ".cu")
    so = os.path.join(BUILD_DIR, "lib" + name + ".so")
    if not is_stale(so, src):
        return {"path": so, "built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private path, then rename: never truncates a library
    # another process has loaded
    tmp = f"{so}.build.{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return {"path": so, "built": True, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so, once per process."""
    return ctypes.CDLL(build(name)["path"])
