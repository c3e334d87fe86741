"""The applications of the port (from the JAX package's scripts/):
the workload demos (denoise, inpaint, super-resolution), the RD curve, the
layered-bitstream studies (images, video), the studies that build on the
bench modules (exp_lsinit, exp_lsri_quant, exp_recode_matrix,
exp_a_domain, dryrun_tp_bigk), the quick smoke drive and the content
they read (the families, the bench images, clips and light fields).  Each
keeps its script's name, flags and JSON keys and runs as
`python -m smoe_tpu_torch.apps.<name>`, on the card unless `--device cpu`
is given."""

from __future__ import annotations


def add_device_arg(ap, cpu_flag: bool = False) -> None:
    """--device (default cuda); with cpu_flag also the script's --cpu,
    which means --device cpu."""
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda)")
    if cpu_flag:
        ap.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")


def device_of(device: str, cpu: bool = False) -> str:
    """The run's device from --device and --cpu; a CUDA device with no GPU
    present fails rather than carry on on the CPU."""
    import torch
    device = "cpu" if cpu else device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device
