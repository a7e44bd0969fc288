"""gluon.Parameter — a ``torch.nn.Parameter`` with the reference's surface.

Counterpart of ``mxnet_tpu/gluon/parameter.py:22-244``. Two ways to build
one:

- the reference's, ``Parameter(name, shape=None, dtype="float32",
  lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
  differentiable=True, stype="default", grad_req="write", ...)``: a
  placeholder of zeros on the CPU (an empty tensor while a dimension is
  unknown) until ``initialize``, ``set_data`` or a loaded file fills it;
- the port's, ``Parameter(tensor, requires_grad=True, grad_req="write",
  lr_mult=1.0, wd_mult=1.0, init=None)``: initialized with that tensor's
  data (the layers build theirs through ``gluon.block.new_parameter``,
  zeros not yet initialized).

**``data`` and ``grad``.** torch reads ``.data`` and ``.grad`` as
attributes; the reference calls ``data()`` and ``grad()``. Both hold: the
class's ``data``/``grad`` getters return torch's own tensor (the detached
alias of the data; the gradient itself, or None) re-classed in place as a
small tensor subclass (``_DataView``, ``_GradView``) whose ops are torch's
own and give plain tensors (its ``__torch_function__`` is torch's disabled
one), and which, called, gives the reference's NDArray:

- ``p.data()`` is an NDArray over the parameter **itself** (not over the
  detached alias), so a body that reads it (the reference GPT's tied head,
  ``np.matmul(x, self.tok_embed.weight.data().T)``) differentiates into
  the parameter. Under ``gluon.block.rebound`` a module reads an alias of
  the parameter, and ``alias.data()`` wraps that alias. Writing through it
  (``p.data()[:] = x``) writes the parameter in place;
- ``p.grad()`` is an NDArray over the gradient. ``initialize()`` (and
  ``set_data`` or ``load_parameters`` filling a parameter not yet
  initialized) attach a zero gradient, as the reference's
  ``_attach_grad``; before that, or after ``p.grad = None``, ``p.grad`` is
  None as in torch. On ``grad_req='null'`` ``p.grad`` is None, as torch
  has it for a frozen parameter, so ``p.grad()`` fails there with
  ``TypeError``; :meth:`Parameter.list_grad` raises :class:`MXNetError`,
  as the reference's ``grad()`` does (:157-168).

``p.grad`` is the gradient tensor itself (the same object on every read),
so torch's own code that writes through it (``nn.Module._apply``'s
``p.grad.data = ...``, the ``Trainer``, the fused update, ``is`` checks)
lands on the real slot. The setters are torch's (``p.data = t`` fills,
``p.grad = None`` drops the gradient), so ``copy.deepcopy`` and the
captured steps work as on any parameter.

``grad_req``:

- ``'write'`` (the default): each backward that reaches the parameter
  overwrites its ``.grad``, as the reference does. Torch adds into
  ``.grad``; a hook on the parameter keeps the gradient a backward brings
  and, once torch has accumulated it, writes it over the sum.
- ``'add'``: torch's own accumulation — gradients of successive backward
  calls add up until the caller zeroes them (:meth:`Parameter.zero_grad`).
- ``'null'``: no gradient (``requires_grad`` False, ``.grad`` dropped); the
  ``Trainer`` skips the parameter.

A backward that does not reach a parameter leaves its ``.grad`` as it was,
in every mode, as in the reference.

A row-sparse gradient (``p.grad = RowSparseNDArray(...)``, as a
``row_sparse_pull`` or a sparse embedding backward gives one) is held
beside torch's slot and read back by ``p.grad`` until ``p.grad`` is set
again, ``zero_grad`` drops it or a backward reaches the parameter (its
dense gradient is then ``p.grad``); the ``Trainer`` updates such a
parameter alone, through the optimizer's lazy row-sparse path.

Initialization (reference :79-130). ``initialize(init, ctx,
default_init, force_reinit, device)`` fills the parameter by the
reference's fill by name from its own initializer, else ``init``, else
``default_init``, else ``Uniform(0.07)``, drawing from a CPU
``torch.Generator``; it leaves an initialized parameter as it is unless
``force_reinit``. ``ctx``/``device`` moves it there (the same object);
without one it stays where it is (a reference-style placeholder goes to
the current context). ``data()`` of a parameter that nothing initialized
raises, as the reference's; an in-place write into it (``p.copy_(...)``,
``load_state_dict``) counts as initializing it. (The port's layers compute
with such a parameter's zeros, as they always have; the reference's raise.)

Deferred shapes (reference :28, :89-130): a parameter whose shape holds a 0
(a layer built without ``in_units``/``in_channels``) is a placeholder, an
empty tensor, until the first forward gives its shape. ``initialize()``
only records its initializer (with the generator and the name);
:meth:`Parameter._finish_deferred_init` then fills it **in place**, the
same object, so a ``Trainer`` built before the first forward holds it.
Filling one inside a CUDA graph capture raises: the capture would record an
allocation and a host-side draw that no replay repeats. ``data()`` of a
placeholder awaiting its shape raises :class:`DeferredInitializationError`.

``cast(dtype)`` changes the parameter's dtype in place (reference :211): the
same object, so trainers and blocks that hold it see the new data, with a
zero gradient of the new dtype attached.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as onp
import torch

from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, to_dtype
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import RowSparseNDArray

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]

_GRAD_REQS = ("write", "add", "null")
# torch's own descriptors, which the views below stand in front of
_DATA = torch._C.TensorBase.data
_GRAD = torch._C.TensorBase.grad
_SHAPE = torch._C.TensorBase.shape


class DeferredInitializationError(MXNetError):
    """A parameter read before its shape could be inferred."""


class _DataView(torch.Tensor):
    """torch's alias of a parameter's data: called, the NDArray over the
    parameter itself (see the module docstring)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __call__(self, ctx=None):
        return self._owner._nd()


class _GradView(torch.Tensor):
    """A parameter's gradient, re-classed in place: called, an NDArray over
    it."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __call__(self, ctx=None):
        return _InPlace(self.as_subclass(torch.Tensor))


class _InPlace(NDArray):
    """``p.data()`` (an NDArray over the parameter itself) or ``p.grad()``:
    a write through it (``p.data()[:] = x``, ``+=``) writes the parameter or
    the gradient in place."""

    __slots__ = ()

    def _set_data(self, data):
        with torch.no_grad():
            self._data.copy_(data)


def _known(shape):
    return shape is not None and all(int(s) > 0 for s in shape)


class Parameter(torch.nn.Parameter):
    """``Parameter(name, shape=None, dtype="float32", ...)`` (the
    reference's) or ``Parameter(tensor, requires_grad=True,
    grad_req="write", lr_mult=1.0, wd_mult=1.0, init=None)`` (the port's);
    see the module docstring. Ops on it return plain tensors, as on any
    ``torch.nn.Parameter``."""

    def __new__(cls, data=None, *args, **kwargs):
        if isinstance(data, torch.Tensor):
            spec = _tensor_form(data, *args, **kwargs)
        else:
            if data is not None:
                args = (data, *args)
            spec = _reference_form(*args, **kwargs)
        t = spec.pop("tensor")
        if type(t) is not torch.Tensor:
            t = t.detach()
        self = super().__new__(cls, t, spec["grad_req"] != "null")
        self._setup(**spec)
        return self

    def __init__(self, *args, **kwargs):
        pass    # __new__ set everything up

    def _setup(self, name, grad_req, lr_mult, wd_mult, init, initialized,
               allow_deferred_init, home, unknown_rank=False):
        self._name = name
        self._grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.mx_init = init_mod.create(init)
        self.allow_deferred_init = allow_deferred_init
        self._initialized = initialized
        self._v0 = self._version
        self._home = home           # placed on a device (else: at init)
        self._unknown_rank = unknown_rank
        # (initializer, generator, name) recorded by initialize() while the
        # shape is unknown
        self._deferred_init = None
        self._fresh_grad = None
        self._hooked = False
        if self.requires_grad:
            self._hook()

    def _hook(self):
        """The two hooks of ``'write'`` (torch takes hooks only on a tensor
        that requires grad, so a ``'null'`` parameter gets them when it
        first leaves ``'null'``)."""
        if self._hooked:
            return
        ref = weakref.ref(self)

        def keep(g):   # before torch accumulates: the gradient it brings
            p = ref()
            if p is not None and p._grad_req == "write":
                p._fresh_grad = g

        self.register_hook(keep)
        self.register_post_accumulate_grad_hook(_overwrite)
        self._hooked = True

    # -- torch's attributes, callable as the reference's methods -------------
    @property
    def data(self):
        t = _DATA.__get__(self)
        t.__class__ = _DataView
        t._owner = self
        return t

    @data.setter
    def data(self, value):
        _DATA.__set__(self, value)
        self._initialized = True

    _row_sparse_grad = None

    @property
    def grad(self):
        if self._row_sparse_grad is not None:
            return self._row_sparse_grad
        g = _GRAD.__get__(self)
        if type(g) is torch.Tensor:    # not a subclass of its own
            g.__class__ = _GradView
        return g

    @grad.setter
    def grad(self, value):
        if isinstance(value, RowSparseNDArray):
            self._row_sparse_grad = value
            return
        self._row_sparse_grad = None
        _GRAD.__set__(self, value)

    @grad.deleter
    def grad(self):
        self._row_sparse_grad = None
        _GRAD.__set__(self, None)

    @property
    def shape(self):
        """The shape: a ``torch.Size`` (0 for an unknown dimension), None
        while even the rank is unknown. Setting it fills unknown dimensions
        only."""
        return None if self._unknown_rank else _SHAPE.__get__(self)

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(n) for n in new_shape)
        if tuple(_SHAPE.__get__(self)) == new_shape and \
                not self._unknown_rank:
            return
        if not self._unknown_rank:
            self._check_fill(new_shape)
        self._unknown_rank = False
        if _known(new_shape) and self._deferred_init is not None:
            self._finish_deferred_init(new_shape)
            return
        with torch.no_grad():
            _DATA.__set__(self, torch.zeros(new_shape, dtype=self.dtype,
                                            device=self.device))

    @property
    def name(self):
        return self._name

    def _nd(self):
        """The NDArray over this parameter (``data()``), after the
        reference's checks."""
        if not self._ready():
            self._raise_uninitialized()
        return _InPlace(self)

    # -- state ------------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError(
                f"grad_req must be one of {_GRAD_REQS}, got {req!r}")
        self._grad_req = req
        self.requires_grad_(req != "null")
        if req == "null":
            _GRAD.__set__(self, None)
        else:
            self._hook()

    @property
    def is_deferred(self):
        """True while the shape holds a 0 (or the rank is unknown): a
        placeholder awaiting its first forward (or a loaded file)."""
        return self._unknown_rank or not all(_SHAPE.__get__(self))

    def _ready(self):
        """True once initialized: by ``initialize``, ``set_data``, a load,
        a fill, a ``.data`` assignment, or an in-place write."""
        if not self._initialized and self._version != self._v0 and \
                not self.is_deferred:
            self._initialized = True
        return self._initialized

    def _raise_uninitialized(self):
        if self.is_deferred and self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter {self.name} awaits shape inference; run a "
                "forward pass or call infer_shape first")
        raise MXNetError(f"parameter {self.name} is not initialized; call "
                         ".initialize() first")

    def _check_fill(self, shape):
        """Raise unless the placeholder may become ``shape`` now: the same
        rank, every known extent kept, and no CUDA graph capturing."""
        old = tuple(_SHAPE.__get__(self))
        if not self._unknown_rank and (len(shape) != len(old) or any(
                o and o != n for o, n in zip(old, shape))):
            raise MXNetError(f"cannot change the shape of parameter "
                             f"{self.name} from {old} to {tuple(shape)}")
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f"parameter of shape {old} is filled during a "
                "CUDA graph capture: run one forward before capturing")

    @torch.no_grad()
    def _fill(self, data, device=None):
        """Become ``data`` (a tensor of this parameter's final shape), in
        place: the same object, its gradient dropped."""
        self._check_fill(tuple(data.shape))
        self._unknown_rank = False
        _DATA.__set__(self, data.to(device=device or self.device,
                                    dtype=self.dtype))
        _GRAD.__set__(self, None)
        self._deferred_init = None
        self._initialized = True

    @torch.no_grad()
    def _finish_deferred_init(self, shape):
        """Give the placeholder its ``shape`` and fill it from the
        initializer ``initialize()`` recorded (zeros when none was, still
        not initialized), by the reference's fill by name."""
        shape = tuple(int(n) for n in shape)
        self._check_fill(shape)
        host = torch.zeros(shape, dtype=torch.float32)
        pending = self._deferred_init
        if pending is None:
            self._unknown_rank = False
            _DATA.__set__(self, host.to(device=self.device,
                                        dtype=self.dtype))
            return
        init, gen, name = pending
        init.init_array(name, host, gen)
        self._fill(host)
        self._attach_grad()

    def _attach_grad(self):
        """A zero gradient, as the reference's ``_attach_grad``."""
        if self._grad_req != "null":
            _GRAD.__set__(self, torch.zeros_like(_DATA.__get__(self)))

    # -- the reference's methods ------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, device=None):
        """Fill from ``init``, else this parameter's own initializer, else
        ``default_init``, else ``Uniform(0.07)`` (reference :79); see the
        module docstring."""
        gen = torch.Generator()
        gen.seed()
        self._initialize(init, ctx if device is None else device,
                         default_init, force_reinit, gen, self.name)

    @torch.no_grad()
    def _initialize(self, init, ctx, default_init, force_reinit, gen, name):
        if isinstance(ctx, (list, tuple)):
            if len(ctx) > 1:
                raise MXNetError("a parameter lives on one device; pass one "
                                 "ctx")
            ctx = ctx[0]
        if ctx is not None or self._home is None:
            self.reset_ctx(ctx)
        if self._ready() and not force_reinit:
            return
        initializer = init_mod.create(init) or self.mx_init or \
            init_mod.create(default_init) or init_mod.Uniform(0.07)
        if self.is_deferred:
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"parameter {self.name} has unknown shape "
                    f"{self.shape} and allow_deferred_init is False")
            self._deferred_init = (initializer, gen, name)
            return
        host = torch.empty(tuple(_SHAPE.__get__(self)), dtype=torch.float32)
        initializer.init_array(name, host, gen)
        self.copy_(host)
        self._initialized = True
        self._deferred_init = None
        self._attach_grad()

    def list_data(self):
        return [self.data()]

    def list_grad(self):
        if self._grad_req == "null":
            raise MXNetError(f"parameter {self.name} has grad_req='null'")
        return [self.grad()]

    def list_ctx(self):
        return [self.data().ctx]

    @torch.no_grad()
    def set_data(self, data):
        """Set the value (reference :170): a copy in place into an
        initialized parameter of the same shape (the same address, so
        captured programs read it), else a fill; a parameter not yet
        initialized gets a zero gradient."""
        t = _tensor_of(data)
        fresh = not self._ready()
        if self.is_deferred:
            dev = self.device if self._home is not None else (
                t.device if isinstance(data, (torch.Tensor, NDArray))
                else resolve_device(None))
            self._fill(t, dev)
            self._home = dev
        else:
            if tuple(t.shape) != tuple(_SHAPE.__get__(self)):
                raise MXNetError(
                    f"shape mismatch for parameter {self.name}: expected "
                    f"{tuple(self.shape)}, got {tuple(t.shape)}")
            if self._home is None:
                self.reset_ctx(t.device if isinstance(
                    data, (torch.Tensor, NDArray)) else None)
            self.copy_(t)
            self._initialized = True
        if fresh:
            self._attach_grad()

    def zero_grad(self):
        """Zero the gradient in place (reference :196); a row-sparse one
        is dropped (no rows)."""
        self._row_sparse_grad = None
        g = _GRAD.__get__(self)
        if g is not None:
            g.zero_()

    @torch.no_grad()
    def reset_ctx(self, ctx):
        """Move the data (and gradient) to ``ctx`` (None: the current
        context), the same object (reference :203)."""
        dev = resolve_device(ctx)
        self._home = dev
        if self.device == dev:
            return
        g = _GRAD.__get__(self)
        _DATA.__set__(self, _DATA.__get__(self).to(dev))
        _GRAD.__set__(self, None if g is None else g.to(dev))

    reset_device = reset_ctx

    @torch.no_grad()
    def cast(self, dtype):
        """Change the dtype of the data to ``dtype`` (a torch dtype or its
        name) in place; a parameter that takes gradients gets a zero
        gradient of the new dtype (reference :211). The data moves to new
        memory, so a compiled train step that captured the old address
        captures anew at its next call."""
        _DATA.__set__(self, _DATA.__get__(self).to(to_dtype(dtype)))
        _GRAD.__set__(self, None)
        self._attach_grad()

    def var(self):
        """A Symbol variable of this parameter's name (reference :226)."""
        from ..symbol import var

        return var(self.name)

    def __repr__(self):
        shape = None if self._unknown_rank else tuple(_SHAPE.__get__(self))
        return (f"Parameter {self.name} (shape={shape}, "
                f"dtype={dtype_name(self.dtype)})")

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        new = type(self)(_DATA.__get__(self).clone(
            memory_format=torch.preserve_format), grad_req=self._grad_req,
            lr_mult=self.lr_mult, wd_mult=self.wd_mult, init=self.mx_init)
        new._name = self._name
        new._initialized = self._initialized
        new._home = self._home
        new._unknown_rank = self._unknown_rank
        new.allow_deferred_init = self.allow_deferred_init
        new._deferred_init = self._deferred_init
        memo[id(self)] = new
        return new

    def __reduce_ex__(self, proto):
        return (torch._utils._rebuild_parameter,
                (_DATA.__get__(self), self.requires_grad, OrderedDict()))


class Constant(Parameter):
    """A parameter holding a fixed value (reference :229-244):
    ``grad_req`` ``'null'``, initialized with its value when made (on the
    value's device; host data on the CPU, moved by ``initialize(ctx=)``),
    so ``initialize`` is a no-op unless ``force_reinit`` (which writes the
    value back)."""

    def __new__(cls, value, name="const"):
        t = _tensor_of(value)
        self = super().__new__(cls, t.detach().clone(), grad_req="null",
                               init=init_mod.Constant(t.detach().cpu()))
        self._name = name
        self._home = t.device if isinstance(
            value, (torch.Tensor, NDArray)) else None
        return self

    def __init__(self, *args, **kwargs):
        pass

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, device=None):
        super().initialize(self.mx_init, ctx, None, force_reinit, device)


def _tensor_of(data):
    """``data`` (an NDArray, a tensor or array-like) as a tensor."""
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    a = onp.asarray(data)
    if a.dtype == onp.float64:
        a = a.astype(onp.float32)
    return torch.from_numpy(onp.array(a, copy=True))


def _tensor_form(data, requires_grad=True, grad_req="write", lr_mult=1.0,
                 wd_mult=1.0, init=None):
    if grad_req not in _GRAD_REQS:
        raise MXNetError(
            f"grad_req must be one of {_GRAD_REQS}, got {grad_req!r}")
    return dict(tensor=data, name="param",
                grad_req=grad_req if requires_grad else "null",
                lr_mult=lr_mult, wd_mult=wd_mult, init=init,
                initialized=True, allow_deferred_init=True, home=data.device)


def _reference_form(name="param", shape=None, dtype="float32", lr_mult=1.0,
                    wd_mult=1.0, init=None, allow_deferred_init=False,
                    differentiable=True, stype="default", grad_req="write",
                    grad_stype="default"):
    if grad_req not in _GRAD_REQS:
        raise MXNetError(
            f"grad_req must be one of {_GRAD_REQS}, got {grad_req!r}")
    # stype and grad_stype: accepted and ignored, as the reference's (a
    # row-sparse gradient is handed over as p.grad = RowSparseNDArray(...))
    dims = None if shape is None else tuple(
        0 if d is None or int(d) < 0 else int(d) for d in shape)
    tensor = torch.zeros(dims if dims is not None else (0,),
                         dtype=to_dtype(dtype))
    return dict(tensor=tensor, name=name or "param",
                grad_req=grad_req if differentiable else "null",
                lr_mult=lr_mult, wd_mult=wd_mult, init=init,
                initialized=False, allow_deferred_init=allow_deferred_init,
                home=None, unknown_rank=dims is None)


def _overwrite(p):
    """After torch accumulated into ``p.grad``: under ``'write'``, put the
    fresh gradient in place of the sum. The dense gradient takes the place
    of a row-sparse one (the reference's one slot, which backward writes)."""
    p._row_sparse_grad = None
    fresh, p._fresh_grad = p._fresh_grad, None
    g = _GRAD.__get__(p)
    if fresh is not None and g is not fresh:
        g.copy_(fresh)
