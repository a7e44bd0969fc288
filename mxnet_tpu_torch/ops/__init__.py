"""Operators of the port: the registry and its one dispatch chokepoint
(:mod:`.registry`), the core ops (:mod:`._core`), indexing
(:mod:`.indexing`), the neural-network ops (:mod:`.nn`) over the
hand-written CUDA kernels in :mod:`.cuda_kernels`, and the samplers
(:mod:`.random_ops`)."""
from . import registry  # noqa: I001 — the registry first: the ops register in it
from . import _core, cuda_kernels, indexing, nn, random_ops
from .registry import apply_op, get_op, invoke, list_ops, register

__all__ = ["registry", "cuda_kernels", "indexing", "nn", "random_ops",
           "apply_op", "get_op", "invoke", "list_ops", "register"]
