"""Parallelism layer of the port (reference: ``mxnet_tpu/parallel/``).

Ported: the flat bucket layout (:class:`collectives.BucketSpec`, one shard),
which the fused multi-tensor update and the compiled train step use, and
:class:`learner.Learner`, the whole training step as one CUDA graph on one
device (``to_optax``: the optimizers' optax semantics). Meshes,
collectives, ZeRO-1, FSDP and tensor or pipeline parallelism are not ported
yet (ROADMAP A8).
"""
from .collectives import BucketSpec
from .learner import GradientTransformation, Learner, to_optax

__all__ = ["BucketSpec", "Learner", "to_optax", "GradientTransformation"]
