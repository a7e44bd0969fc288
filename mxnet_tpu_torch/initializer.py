"""Parameter initializers (the subset the GPT family uses).

Counterpart of ``mxnet_tpu/initializer.py``. An initializer fills a tensor
in place from a ``torch.Generator``. The two packages draw different random
numbers from the same seed, so parity between them carries weights across
(:func:`mxnet_tpu_torch.convert.params_from_mxnet_tpu`) instead of
re-drawing them.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "create"]


class Initializer:
    def __call__(self, tensor, generator):
        raise NotImplementedError


class Uniform(Initializer):
    """U(-scale, scale) (the reference's default, scale 0.07)."""

    def __init__(self, scale=0.07):
        self.scale = float(scale)

    def __call__(self, tensor, generator):
        vals = torch.rand(tensor.shape, generator=generator)
        tensor.copy_(vals * (2 * self.scale) - self.scale)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        self.sigma = float(sigma)

    def __call__(self, tensor, generator):
        tensor.copy_(torch.randn(tensor.shape, generator=generator)
                     * self.sigma)


class Zero(Initializer):
    def __call__(self, tensor, generator):
        tensor.zero_()


class One(Initializer):
    def __call__(self, tensor, generator):
        tensor.fill_(1.0)


def create(spec):
    """An initializer from an instance, ``None``, or the names ``"zeros"``
    / ``"ones"`` the layers use."""
    if spec is None or isinstance(spec, Initializer):
        return spec
    if spec == "zeros":
        return Zero()
    if spec == "ones":
        return One()
    raise MXNetError(f"unknown initializer {spec!r}")
