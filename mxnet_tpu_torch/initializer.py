"""Parameter initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (:25-181) for ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier`` and ``MSRAPrelu``. An initializer fills
a tensor in place from a ``torch.Generator``. ``init_array(name, tensor,
generator)`` is the reference's fill by name (:57-66): a parameter whose
name ends in ``bias``, ``beta``, ``running_mean`` or ``moving_mean`` gets
zeros, one ending in ``gamma``, ``running_var`` or ``moving_var`` ones,
whatever the initializer; any other gets the initializer's own draw
(``_init_weight``).

The two packages draw different random numbers from the same seed, so
parity between them carries weights across
(:func:`mxnet_tpu_torch.convert.params_from_mxnet_tpu`) instead of
re-drawing them; the tests hold the draws to the reference's shapes and
moments.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "create"]

_ZEROS = ("bias", "beta", "running_mean", "moving_mean")
_ONES = ("gamma", "running_var", "moving_var")


class Initializer:
    """Base initializer; subclasses implement ``_init_weight(name, tensor,
    generator)``."""

    def init_array(self, name, tensor, generator):
        """Fill ``tensor`` for the parameter ``name``: by name first (the
        reference's rule), else by this initializer's draw."""
        name = name.lower()
        if name.endswith(_ZEROS):
            tensor.zero_()
        elif name.endswith(_ONES):
            tensor.fill_(1.0)
        else:
            self._init_weight(name, tensor, generator)

    def _init_weight(self, name, tensor, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.zero_()


class One(Initializer):
    def _init_weight(self, name, tensor, generator):
        tensor.fill_(1.0)


class Constant(Initializer):
    """Every entry ``value`` (reference :94-104): a number, or an array
    (NDArray, tensor or numpy) broadcast to the parameter's shape."""

    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, name, tensor, generator):
        v = getattr(self.value, "_data", self.value)
        if isinstance(v, (int, float)):
            tensor.fill_(v)
        else:
            tensor.copy_(torch.as_tensor(v).to(tensor.dtype)
                         .expand(tensor.shape))


class Uniform(Initializer):
    """U(-scale, scale) (the reference's default, scale 0.07)."""

    def __init__(self, scale=0.07):
        self.scale = float(scale)

    def _init_weight(self, name, tensor, generator):
        vals = torch.rand(tensor.shape, generator=generator)
        tensor.copy_(vals * (2 * self.scale) - self.scale)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        self.sigma = float(sigma)

    def _init_weight(self, name, tensor, generator):
        tensor.copy_(torch.randn(tensor.shape, generator=generator)
                     * self.sigma)


class Xavier(Initializer):
    """Glorot's initialisation (reference :145-173), the convolutions'
    default: scale = sqrt(magnitude / factor), the factor the fan in, out or
    their mean, each fan counted over the kernel dims of a conv weight (O,
    I, *k); ``rnd_type`` ``"uniform"`` draws U(-scale, scale), anything else
    N(0, scale^2)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, tensor, generator):
        shape = tuple(tensor.shape)
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got shape {shape} "
                             f"for {name}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0,
                  "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            vals = torch.rand(shape, generator=generator) * (2 * scale) - scale
        else:
            vals = torch.randn(shape, generator=generator) * scale
        tensor.copy_(vals)


class MSRAPrelu(Xavier):
    """He's initialisation for PReLU (reference :176-181): Xavier with
    Gaussian draws and magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


# the reference's registered names (lower-cased class names and aliases)
# that these classes cover
_NAMES = {"zero": Zero, "zeros": Zero, "one": One, "ones": One,
          "constant": Constant,
          "uniform": Uniform, "normal": Normal, "xavier": Xavier,
          "msraprelu": MSRAPrelu}


def create(spec, **kwargs):
    """An initializer from an instance, ``None`` (none of its own), or a
    registered name (``"xavier"``, ``"zeros"``, ...; any case) built with
    ``kwargs``."""
    if spec is None or isinstance(spec, Initializer):
        return spec
    if isinstance(spec, str) and spec.lower() in _NAMES:
        return _NAMES[spec.lower()](**kwargs)
    raise MXNetError(f"unknown initializer {spec!r}")
