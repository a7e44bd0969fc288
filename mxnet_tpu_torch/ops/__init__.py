"""Operators of the port: the registry and its one dispatch chokepoint
(:mod:`.registry`), the core ops (:mod:`._core`), indexing
(:mod:`.indexing`), the neural-network ops (:mod:`.nn`) over the
hand-written CUDA kernels in :mod:`.cuda_kernels`, the samplers
(:mod:`.random_ops`), the reference's ``extra.py`` (:mod:`.extra`: the
interleaved attention products, ``im2col``/``col2im``, the AMP casts, the
layout ops, bipartite matching, the MultiBox trio, the numpy stragglers
and the CSR product), the optimizer update ops, dense, mixed-precision,
multi-tensor and row-sparse (:mod:`.optimizer_ops`), the detection and
resize ops (:mod:`.vision`), the warping and deformable ops
(:mod:`.warp_ops`) and the fused recurrent op ``rnn`` (:mod:`.rnn`). The
legacy tensor tier: the scalar, creation, slice and legacy NN ops
(:mod:`.legacy_elemwise`), the ``linalg_*`` family (:mod:`.linalg_legacy`)
and the dynamic-shape and contrib ops (:mod:`.npi_manip`); the quantized
int8 family and the intgemm protocol (:mod:`.quantized_ops`, integer
products on cuBLASLt's int8 GEMM on the card); sliding-window attention, the
DGL graph ops and the image and cv ops (:mod:`.graph_image_ops`). They register in the
reference's order (``mxnet_tpu/ops/__init__.py``); its alias table
(:mod:`.aliases`) registers its names last."""
from . import registry  # noqa: I001 — the registry first: the ops register in it
from . import _core, nn, indexing, rnn, vision, extra, linalg_legacy
from . import optimizer_ops, legacy_elemwise, random_ops, quantized_ops
from . import graph_image_ops, npi_manip
from . import cuda_kernels, warp_ops
from . import aliases as _aliases
from .registry import apply_op, get_op, invoke, list_ops, register

_aliases._register_all()

__all__ = ["registry", "cuda_kernels", "extra", "graph_image_ops",
           "indexing", "legacy_elemwise",
           "linalg_legacy", "nn", "npi_manip", "optimizer_ops", "quantized_ops",
           "random_ops", "rnn", "vision", "warp_ops",
           "apply_op", "get_op", "invoke", "list_ops", "register"]
