"""Parameter initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (:25-297): ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``InitDesc``, ``Load`` and
``Mixed``. An initializer fills a tensor in place from a
``torch.Generator``. ``init_array(name, tensor, generator)`` is the
reference's fill by name (:57-66): a parameter whose
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

import logging
import math
import re

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Load", "Mixed", "create"]

_ZEROS = ("bias", "beta", "running_mean", "moving_mean")
_ONES = ("gamma", "running_var", "moving_var")


class InitDesc(str):
    """A parameter's name carrying ``attrs`` and a fallback initializer
    (reference :212): an ``__init__`` attribute (an initializer's name)
    wins over the initializer called, then ``global_init``."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer; subclasses implement ``_init_weight(name, tensor,
    generator)``."""

    def __call__(self, name, tensor=None, generator=None):
        """Fill ``tensor`` for ``name`` (reference :42); ``init(tensor)``
        fills it with no name. An :class:`InitDesc` name's ``__init__``
        attribute, else its ``global_init``, fills it instead."""
        if tensor is None:
            tensor, name = name, ""
        if isinstance(name, InitDesc):
            spec = name.attrs.get("__init__")
            if spec:
                create(spec).init_array(str(name), tensor, generator)
                return
            if name.global_init is not None and \
                    name.global_init is not self:
                name.global_init.init_array(str(name), tensor, generator)
                return
        self.init_array(str(name or ""), tensor, generator)

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


class Orthogonal(Initializer):
    """A (scaled) orthogonal matrix over (shape[0], prod(shape[1:]))
    (reference :131): the Q of a QR of a square Gaussian draw of the larger
    extent, its signs fixed by R's diagonal so Q is Haar-distributed (as
    ``jax.random.orthogonal``), cut to the shape and times ``scale``. The
    draws differ from the reference's; the property holds: the rows (or
    columns, whichever are fewer) are orthonormal times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, tensor, generator):
        nout = tensor.shape[0]
        nin = math.prod(tensor.shape[1:])
        n = max(nout, nin)
        a = torch.randn((n, n), generator=generator, dtype=torch.float64)
        q, r = torch.linalg.qr(a.to(tensor.device))
        q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
        tensor.copy_((q[:nout, :nin] * self.scale).reshape(tensor.shape))


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


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, H, W) deconvolution
    weight (reference :184)."""

    def _init_weight(self, name, tensor, generator):
        shape = tuple(tensor.shape)
        f = shape[3] / 2.0
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = onp.arange(math.prod(shape))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c))
        tensor.copy_(torch.from_numpy(
            w.astype("float32").reshape(shape)))


class LSTMBias(Initializer):
    """An LSTM's bias: zeros, the forget gate's quarter ``forget_bias``
    (reference :198; gates in the order i, f, g, o). As in the reference,
    the fill by name comes first: a name ending in ``bias`` gets zeros."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, name, tensor, generator):
        n = tensor.shape[0] // 4
        tensor.zero_()
        tensor[n:2 * n] = self.forget_bias


class Load(Initializer):
    """Fill from saved parameters (reference :225): a ``.params`` file or a
    ``{name: array}`` dict, ``arg:``/``aux:`` prefixes dropped; a name
    absent from it falls to ``default_init``, else raises."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            with onp.load(param) as z:
                param = {n: z[n] for n in z.files}
        if not isinstance(param, dict):
            raise MXNetError("Load needs a file path or a name->NDArray "
                             f"dict, got {type(param).__name__}")
        self.param = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def init_array(self, name, tensor, generator=None):
        log = logging.getLogger("mxnet_tpu_torch")
        if name in self.param:
            src = self.param[name]
            src = getattr(src, "_data", src)
            if tuple(tensor.shape) != tuple(src.shape):
                raise MXNetError(
                    f"parameter {name!r} cannot be initialized by loading: "
                    f"target shape {tuple(tensor.shape)} vs loaded "
                    f"{tuple(src.shape)}")
            tensor.copy_(torch.as_tensor(onp.asarray(
                src.detach().cpu() if isinstance(src, torch.Tensor)
                else src)).to(tensor.dtype))
            if self.verbose:
                log.info("Initialized %s by loading", name)
        elif self.default_init is not None:
            self.default_init(name, tensor, generator)
            if self.verbose:
                log.info("Initialized %s by default", name)
        else:
            raise MXNetError(
                f"cannot initialize {name!r}: not in the loaded params and "
                "no default initializer provided")


class Mixed(Initializer):
    """The initializer of the first regex in ``patterns`` matching the
    name (reference :274); a last ``".*"`` gives the fallback."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed needs equally many patterns and "
                             "initializers")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def init_array(self, name, tensor, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, tensor, generator)
                return
        raise MXNetError(
            f"parameter {name!r} did not match any Mixed pattern — add a "
            "'.*' fallback pattern")


# the reference's registered names (lower-cased class names and aliases)
# that these classes cover
_NAMES = {"zero": Zero, "zeros": Zero, "one": One, "ones": One,
          "constant": Constant, "uniform": Uniform, "normal": Normal,
          "orthogonal": Orthogonal, "xavier": Xavier,
          "msraprelu": MSRAPrelu, "bilinear": Bilinear,
          "lstmbias": LSTMBias, "load": Load, "mixed": Mixed}


def create(spec, **kwargs):
    """An initializer from an instance, ``None`` (none of its own), or a
    registered name (``"xavier"``, ``"zeros"``, ...; any case) built with
    ``kwargs``."""
    if spec is None or isinstance(spec, Initializer):
        return spec
    if isinstance(spec, str) and spec.lower() in _NAMES:
        return _NAMES[spec.lower()](**kwargs)
    raise MXNetError(f"unknown initializer {spec!r}")
