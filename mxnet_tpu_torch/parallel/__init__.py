"""Parallelism layer of the port (reference: ``mxnet_tpu/parallel/``).

Only the flat bucket layout is ported (:class:`collectives.BucketSpec`,
one shard): the fused multi-tensor update and the compiled train step use
it. Meshes, collectives, ZeRO-1, FSDP and tensor or pipeline parallelism
are not ported yet.
"""
from .collectives import BucketSpec

__all__ = ["BucketSpec"]
