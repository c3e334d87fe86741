"""smoe_tpu_torch — the Steered Mixture-of-Experts codec in PyTorch/CUDA.

A second package beside `smoe_tpu` (the JAX reference it is held against).
It imports torch and never jax.  This package imports no submodule, so
`import smoe_tpu_torch` is cheap; the serving decode lives in
`smoe_tpu_torch.codec.serve` and `python -m smoe_tpu_torch.cli.decode`.
"""

__version__ = "0.1.0"
