"""Core layers as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``
(:25) and ``HybridSequential`` (:56) deriving from it, ``Dense`` (:61),
``Dropout`` (:105), ``Flatten`` (:116), ``Identity`` (:124),
``Activation`` (:129), ``LeakyReLU`` (:141), ``PReLU`` (:150), ``ELU``
(:160), ``SELU`` (:169), ``GELU`` (:174), ``Swish``/``SiLU`` (:184),
``BatchNorm`` (:211), ``SyncBatchNorm`` (:273), ``LayerNorm`` (:281),
``GroupNorm`` (:304), ``InstanceNorm`` (:326), ``RMSNorm`` (:347),
``Embedding`` (:365), ``BatchNormReLU`` (:431), ``ReflectionPad2D`` (:439),
``Lambda``/``HybridLambda`` (:383, :396) and
``Concatenate``/``HybridConcatenate`` (:409, :424). Parameter names and
layouts are the reference's: ``Dense.weight`` is (units, in_units), the
norms keep ``gamma``/``beta``, BatchNorm its ``running_mean``/
``running_var`` (parameters with ``grad_req='null'``), PReLU its
``alpha``.

The layers with parameters and the activations are torch code over the
``ops.nn`` doors (``_tensor_body``: NDArray arguments reach them as
tensors, and come back as NDArrays); the containers and the lambdas pass
their arguments on as they came, as the reference's. A layer whose
parameters nothing initialized computes with their zeros, as the port's
layers always have (the reference raises there, in ``data()``, which the
port's ``Parameter.data()`` does too).

Every layer takes the reference's ``**kwargs`` and hands them to its base
(``prefix`` and ``params``, which ``Block`` accepts and ignores, as the
reference's does).

Deferred shapes: ``Dense`` without ``in_units`` and the norms without
``in_channels`` hold placeholders (a 0 in the shape) that their first
forward fills (``Parameter._finish_deferred_init``), as the reference's
``_infer``. A layer given its shapes (as GPT's are) never defers.
"""
from __future__ import annotations

import math

import torch

from ... import _deferred_compute as _dc
from ... import autograd as _ag
from ... import initializer as init_mod
from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ops import nn as F
from ...ops.nn import _Door
from ..block import Block, HybridBlock, new_parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Flatten",
           "Identity", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "GELU", "Swish", "SiLU", "BatchNorm", "SyncBatchNorm",
           "BatchNormReLU", "LayerNorm", "GroupNorm", "InstanceNorm",
           "RMSNorm", "ReflectionPad2D", "Embedding", "Lambda",
           "HybridLambda", "Concatenate", "HybridConcatenate"]


_PAD = _Door("pad")     # the registered op's tensor-level door


def finish_deferred(shape, *params):
    """Fill those of ``params`` still awaiting their shape with ``shape``
    (None entries skipped)."""
    for p in params:
        if p is not None and p.is_deferred:
            p._finish_deferred_init(shape)


class Sequential(Block):
    """Children named ``"0"``, ``"1"``, ... in the order added, run one
    after another (reference :25); a slice is a new container of the same
    type over the same children."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*children[key])
            return net
        return children[key]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential, HybridBlock):
    """A :class:`Sequential` that ``hybridize()`` captures (reference
    :56)."""


class Dense(HybridBlock):
    """Fully connected layer: y = act(x W^T + b), W of shape (units,
    in_units); ``in_units=0`` defers it to the first forward (the
    non-batch extent of x with ``flatten``, else its last)."""

    _tensor_body = True

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = new_parameter((units, in_units), dtype, device,
                                    weight_initializer)
        self.bias = new_parameter((units,), dtype, device,
                                  bias_initializer) if use_bias else None

    def forward(self, x):
        if self.weight.is_deferred:
            self.weight._finish_deferred_init((self._units, math.prod(
                x.shape[1:]) if self._flatten else x.shape[-1]))
        out = F.fully_connected(x, self.weight, self.bias,
                                flatten=self._flatten)
        if self._activation is not None:
            out = F.activation(out, act_type=self._activation)
        return out


class Flatten(HybridBlock):
    """(N, ...) -> (N, everything else)."""

    _tensor_body = True

    def forward(self, x):
        return x.flatten(1)


class Dropout(HybridBlock):
    """Inverted dropout at ``rate`` (reference :105): active inside
    ``autograd.record()`` (or after ``train()``), the identity elsewhere;
    ``axes`` is accepted, as in the reference, and every entry draws its
    own mask."""

    _tensor_body = True

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return F.dropout(x, self._rate, self.training)


class Identity(HybridBlock):
    """Returns its input (reference :124)."""

    def forward(self, x):
        return x


class Activation(HybridBlock):
    """``act_type`` of the ``activation`` op (``"relu"``, ``"tanh"``,
    ...)."""

    _tensor_body = True

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return F.activation(x, act_type=self._act)


class LeakyReLU(HybridBlock):
    """max(x, alpha x) (reference :141)."""

    _tensor_body = True

    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` of shape (in_channels,)
    (reference :150), broadcast over the last axis."""

    _tensor_body = True

    def __init__(self, alpha_initializer=init_mod.Constant(0.25),
                 in_channels=1, device=None, **kwargs):
        super().__init__(**kwargs)
        self.alpha = new_parameter((in_channels,), torch.float32,
                                   resolve_device(device), alpha_initializer)

    def forward(self, x):
        return F.leaky_relu(x, self.alpha, act_type="prelu")


class ELU(HybridBlock):
    """x, or alpha (exp(x) - 1) below 0 (reference :160)."""

    _tensor_body = True

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (reference :169)."""

    _tensor_body = True

    def forward(self, x):
        return F.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """GELU, exact (``approximation="erf"``) or the tanh form (reference
    :174)."""

    _tensor_body = True

    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._act = "gelu" if approximation == "erf" else "gelu_tanh"

    def forward(self, x):
        return F.leaky_relu(x, act_type=self._act)


class Swish(HybridBlock):
    """x * sigmoid(beta x) (reference :184)."""

    _tensor_body = True

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * F.activation(x * self._beta, act_type="sigmoid")


SiLU = Swish


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (reference :211-270).

    While training (``autograd.is_training()``: inside ``autograd.record()``
    — not ``Module.training``) and without ``use_global_stats`` it
    normalises by the batch's stats and writes the new running stats into
    ``running_mean``/``running_var`` **in place** (``copy_`` under
    ``no_grad``), never rebinding them, so a captured step updates the same
    storage on every replay; otherwise it normalises by the running stats.
    ``scale=False`` fixes gamma at ones (``fix_gamma``)."""

    _tensor_body = True

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 dtype="float32", device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._use_global_stats = use_global_stats
        self._scale = scale
        shape = (in_channels,)
        self.gamma = new_parameter(shape, dtype, device, gamma_initializer,
                                   "write" if scale else "null")
        self.beta = new_parameter(shape, dtype, device, beta_initializer,
                                  "write" if center else "null")
        self.running_mean = new_parameter(shape, dtype, device,
                                          running_mean_initializer, "null")
        self.running_var = new_parameter(shape, dtype, device,
                                         running_variance_initializer,
                                         "null")

    def forward(self, x):
        finish_deferred((x.shape[self._axis],), self.gamma, self.beta,
                        self.running_mean, self.running_var)
        update = _ag.is_training() and not self._use_global_stats
        out, new_mean, new_var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._eps, momentum=self._momentum,
            fix_gamma=not self._scale, use_batch_stats=update,
            axis=self._axis)
        if update and _dc.is_tracing():
            # a traced graph writes the statistics after every call
            _dc.register_aux_update(self.running_mean, new_mean)
            _dc.register_aux_update(self.running_var, new_var)
        elif update:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return out


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (reference :273): on the one device the port
    trains on, the batch is the whole batch, so this is
    :class:`BatchNorm`; ``num_devices`` is accepted (across devices it
    comes with ROADMAP A8)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class BatchNormReLU(BatchNorm):
    """BatchNorm, then ReLU (reference :431)."""

    def forward(self, x):
        return F.activation(super().forward(x), act_type="relu")


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis`` with ``gamma``/``beta`` parameters;
    ``in_channels=0`` defers their shape to the first forward."""

    _tensor_body = True

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32", device=None, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        dtype = to_dtype(dtype)
        self._axis = axis
        self._eps = epsilon
        self.gamma = new_parameter((in_channels,), dtype, device,
                                   gamma_initializer,
                                   "write" if scale else "null")
        self.beta = new_parameter((in_channels,), dtype, device,
                                  beta_initializer,
                                  "write" if center else "null")

    def forward(self, x):
        finish_deferred((x.shape[self._axis],), self.gamma, self.beta)
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._eps)


class _NormBase(HybridBlock):
    """The ``gamma``/``beta`` pair of the channel norms (reference :198):
    (in_channels,) float32, ``in_channels=0`` deferring the shape to the
    first forward (channel axis 1); ``scale``/``center`` False freeze
    them (``grad_req='null'``)."""

    _tensor_body = True

    def __init__(self, in_channels, center, scale, gamma_initializer,
                 beta_initializer, device, **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        shape = (in_channels or 0,)
        self.gamma = new_parameter(shape, torch.float32, device,
                                   gamma_initializer,
                                   "write" if scale else "null")
        self.beta = new_parameter(shape, torch.float32, device,
                                  beta_initializer,
                                  "write" if center else "null")


class GroupNorm(_NormBase):
    """GroupNorm over (N, C, ...) with ``num_groups`` groups of channels
    (reference :304)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(in_channels, center, scale, gamma_initializer,
                         beta_initializer, device, **kwargs)
        self._num_groups = num_groups
        self._eps = epsilon

    def forward(self, x):
        finish_deferred((x.shape[1],), self.gamma, self.beta)
        return F.group_norm(x, self.gamma, self.beta,
                            num_groups=self._num_groups, eps=self._eps)


class InstanceNorm(_NormBase):
    """InstanceNorm over (N, C, ...) (reference :326): each sample's
    channel normalised over its spatial extent. ``axis`` is accepted, as
    in the reference, which normalises the channels of axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, **kwargs):
        super().__init__(in_channels, center, scale, gamma_initializer,
                         beta_initializer, device, **kwargs)
        self._eps = epsilon

    def forward(self, x):
        finish_deferred((x.shape[1],), self.gamma, self.beta)
        return F.instance_norm(x, self.gamma, self.beta, eps=self._eps)


class RMSNorm(HybridBlock):
    """RMSNorm over ``axis`` with a ``gamma`` of ones (reference :347);
    ``in_channels=0`` defers its shape to the first forward."""

    _tensor_body = True

    def __init__(self, axis=-1, epsilon=1e-6, in_channels=0, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        self.gamma = new_parameter((in_channels or 0,), torch.float32,
                                   resolve_device(device), "ones")

    def forward(self, x):
        finish_deferred((x.shape[self._axis],), self.gamma)
        return F.rms_norm(x, self.gamma, axis=self._axis, eps=self._eps)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the H and W axes of NCHW input (reference
    :439): ``padding`` an int (all four sides), a ``(left, right, top,
    bottom)`` 4-tuple, or the reference's 8-tuple ``pad_width`` ``(0, 0,
    0, 0, top, bottom, left, right)``. It runs the registered ``pad`` op in
    ``"reflect"`` mode (one gather an axis), which the graph layer records
    and exports."""

    _tensor_body = True

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, (tuple, list)):
            p = tuple(int(v) for v in padding)
            if len(p) == 8:
                p = (p[6], p[7], p[4], p[5])
            elif len(p) != 4:
                raise MXNetError(
                    "ReflectionPad2D takes an int, a (left, right, top, "
                    "bottom) 4-tuple, or the reference 8-tuple pad_width")
        else:
            p = (int(padding),) * 4
        self._pad = p   # (left, right, top, bottom)

    def forward(self, x):
        left, right, top, bottom = self._pad
        return _PAD.fn(pad_width=((0, 0), (0, 0), (top, bottom),
                                  (left, right)), mode="reflect")(x)


class Embedding(HybridBlock):
    """Lookup table of shape (input_dim, output_dim). ``sparse_grad`` is
    accepted and ignored, as in the reference (reference :367): the
    gradient is dense; a row-sparse one is handed over as
    ``p.grad = RowSparseNDArray(...)``."""

    _tensor_body = True

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 **kwargs):
        super().__init__(**kwargs)
        device = resolve_device(device)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = new_parameter((input_dim, output_dim), to_dtype(dtype),
                                    device, weight_initializer)

    def forward(self, x):
        return F.embedding(x, self.weight)


def _np_function(name):
    """The ``mx.np`` (else ``mx.npx``) function named ``name``."""
    from ... import numpy as mnp
    from ... import numpy_extension as mnpx

    for mod in (mnp, mnpx):
        fn = getattr(mod, name, None)
        if fn is not None:
            return fn
    raise MXNetError(f"Lambda: {name!r} names no mx.np or mx.npx function")


class Lambda(Block):
    """``function(*args)`` as a block (reference :383); a string names an
    ``mx.np`` or ``mx.npx`` function."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func = _np_function(function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A :class:`Lambda` that ``hybridize()`` captures (reference :396)."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func = _np_function(function) if isinstance(function, str) \
            else function

    def forward(self, *args):
        return self._func(*args)


class Concatenate(Sequential):
    """Runs every child on the same input and concatenates their outputs
    along ``axis`` (reference :409)."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def forward(self, x):
        from ... import numpy as mnp

        return mnp.concatenate([block(x) for block in
                                self._modules.values()], axis=self._axis)


class HybridConcatenate(Concatenate, HybridBlock):
    """A :class:`Concatenate` that ``hybridize()`` captures (reference
    :424)."""
