"""Operators of the port: :mod:`.nn` (functional ops) over the hand-written
CUDA kernels in :mod:`.cuda_kernels`."""
from . import cuda_kernels, nn

__all__ = ["cuda_kernels", "nn"]
