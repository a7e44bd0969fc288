"""Flat bucket layout of a list of tensors.

Counterpart of ``mxnet_tpu/parallel/collectives.py:45-122``
(``BucketSpec``) for one shard. The reference shares this layout between
the fused multi-tensor update and its sharded ZeRO-1/FSDP schedules, which
pad a bucket to a multiple of the shard count; the port has one device, so
its layout has no padding (the reference's ``n_shards=1``). The sharded
schedules and the collectives of the reference module are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["BucketSpec"]


class BucketSpec:
    """Sizes, offsets and total of tensors of ``shapes`` laid end to end in
    one flat vector."""

    __slots__ = ("shapes", "sizes", "offsets", "total", "_segments")

    def __init__(self, shapes):
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sizes = []
        for s in self.shapes:
            n = 1
            for d in s:
                n *= d
            self.sizes.append(n)
        self.offsets = []
        off = 0
        for n in self.sizes:
            self.offsets.append(off)
            off += n
        self.total = off
        self._segments = {}

    def flatten(self, xs):
        """Concatenate ``xs`` (of ``shapes``) into one flat vector."""
        return torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 \
            else xs[0].reshape(-1)

    def unflatten(self, flat):
        """Views of a flat vector as tensors of ``shapes``."""
        return [flat[o:o + n].view(s)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]

    def segments(self, device):
        """int64 vector of the tensor each element belongs to, made once per
        device (so a captured CUDA graph reads a fixed buffer)."""
        dev = torch.device(device)
        seg = self._segments.get(dev)
        if seg is None:
            seg = torch.repeat_interleave(
                torch.arange(len(self.sizes)),
                torch.tensor(self.sizes, dtype=torch.int64)).to(dev)
            self._segments[dev] = seg
        return seg

    def spread(self, per_tensor):
        """Per-tensor values (a 1-D tensor) -> a per-element flat vector."""
        return per_tensor.index_select(0, self.segments(per_tensor.device))
