"""Carry matplotlib's sample photographs into the PyTorch port's tree, for
its content functions (smoe_tpu_torch/apps/content.py) to read with numpy
alone on a machine without matplotlib or OpenCV.

    python scripts/make_torch_photo_data.py

Needs matplotlib.  Writes byte-for-byte copies of grace_hopper.jpg,
s1045.ima.gz and jacksboro_fault_dem.npz to
smoe_tpu_torch/apps/sample_data/, and checks each source file's sha256
first.  The port decodes the JPEG itself (smoe_tpu_torch/io/jpeg.py).
"""

from __future__ import annotations

import hashlib
import os
import shutil

import matplotlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "smoe_tpu_torch", "apps", "sample_data")
SHA256 = {
    "grace_hopper.jpg":
        "a8ca6d734765703b09728ab47fe59f473d93ae3967fc24c7c0288c3c7adb7130",
    "s1045.ima.gz":
        "32b424d64f62b7e71cb24d29fd53938ad5664d608055a67ab2b2af4369f8b89e",
    "jacksboro_fault_dem.npz":
        "d493f50a33e82a4420494c54d1fca1539d177bdc27ab190bc5fe6e92f62fb637",
}


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main():
    src = os.path.join(matplotlib.get_data_path(), "sample_data")
    for name, want in SHA256.items():
        got = sha256(os.path.join(src, name))
        if got != want:
            raise SystemExit(f"{name}: sha256 {got}, expected {want}")
    os.makedirs(OUT, exist_ok=True)
    for name in SHA256:
        shutil.copyfile(os.path.join(src, name), os.path.join(OUT, name))
    for name in sorted(os.listdir(OUT)):
        path = os.path.join(OUT, name)
        print(f"{name}: {os.path.getsize(path)} bytes, sha256 {sha256(path)}")


if __name__ == "__main__":
    main()
