"""PyTorch/CUDA port of deepsolid_tpu for NVIDIA Hopper GPUs.

Module paths and names mirror the JAX package (`deepsolid_tpu`), which
stays the numerical reference. This package imports neither JAX nor
anything of `deepsolid_tpu`: it keeps its own copies of the host-side
numpy code it needs. Hand-written CUDA kernels live in `ops/cuda/`.
"""

from deepsolid_tpu_torch.device import resolve_device, set_full_precision

__all__ = ["resolve_device", "set_full_precision"]
