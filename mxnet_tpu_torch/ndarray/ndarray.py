"""NDArray: the framework's array type, over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py:64-613``. The payload is a
``torch.Tensor`` on the array's device; torch queues its kernels on a CUDA
stream and returns, so ops return at once and ``wait_to_read`` /
``asnumpy`` are the sync points, as in the reference. Consequences kept
from the reference:

- a write rebinds: ``a[:] = x``, ``a += b`` and ``copyto`` give the array a
  new tensor (:meth:`NDArray._set_data`); any other handle to the old
  tensor (``detach()``, an earlier ``asnumpy()``) keeps its values. An
  array marked for gradients (``attach_grad``) stays marked across a
  rebind, with its gradient buffer;
- every operator goes through ``ops.registry.invoke``, which records for
  autograd only inside ``autograd.record()``;
- one array class serves ``mx.np`` and ``mx.npx``.

NDArrays and tensors mix: ``mx.np`` / ``mx.npx`` take a tensor operand as
it is (an NDArray over it, no copy, so autograd sees the op), an NDArray's
arithmetic takes a tensor operand, and a torch function given an NDArray
(``tensor + ndarray``, ``torch.tanh(ndarray)``) runs on its tensor and
returns NDArrays (:meth:`NDArray.__torch_function__`). Only
:func:`array` of user data copies, as in the reference.

Host constants in a captured body: while a CUDA graph family warms and
captures a program (:func:`host_constants`, entered by
``cached_op.GraphPool``), an array made from host data on the card
(``mx.np.array(-1e30)``) is made once, at the warm call, and kept in the
family's store by value; the capture reads that tensor, so the program
copies nothing from the host and every replay sees the same value.

Gradients live in torch's ``.grad`` of the array's tensor, which
``attach_grad`` makes a leaf; :attr:`grad` wraps it. ``grad_req`` (the
reference's ``'write'``, ``'add'``, ``'null'``) is kept by two hooks on
the tensor, as ``gluon.Parameter`` keeps it: ``'write'`` puts each
backward's gradient in place of the sum torch accumulates, ``'null'``
leaves the zero buffer as it was, ``'add'`` is torch's own accumulation.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import numpy as onp
import torch

from .. import autograd as _ag
from .. import engine
from ..base import MXNetError, canonical_dtype, dtype_name, narrow
from ..context import Context, context_of, resolve_device
from ..ops.registry import apply_op

__all__ = ["NDArray", "array", "from_torch", "wrap", "unwrap",
           "host_constants"]

# functions whose mx.np implementation is numpy-compatible: the numpy
# dispatch protocol routes them to mx.np (reference :42-61)
_NP_DISPATCH_HANDLED = frozenset({
    "concatenate", "stack", "vstack", "hstack", "dstack", "column_stack",
    "split", "array_split", "mean", "sum", "prod", "std", "var", "median",
    "max", "min", "amax", "amin", "argmax", "argmin", "clip", "reshape",
    "transpose", "swapaxes", "moveaxis", "squeeze", "expand_dims",
    "broadcast_to", "tile", "repeat", "flip", "roll", "rot90", "where",
    "take", "dot", "matmul", "tensordot", "inner", "outer", "kron",
    "trace", "diag", "diagonal", "tril", "triu", "sort", "argsort",
    "cumsum", "cumprod", "einsum", "atleast_1d", "atleast_2d",
    "atleast_3d", "ravel", "nansum", "nanmean", "nanmax", "nanmin",
    "quantile", "percentile", "average", "cov", "corrcoef", "bincount",
    "diff", "ediff1d", "interp", "meshgrid", "linspace", "logspace",
    "pad", "searchsorted", "digitize", "histogram", "zeros_like",
    "ones_like", "full_like",
})


def _numpy_dtype(dt):
    """The numpy dtype of a torch dtype, as the reference's arrays report
    it (bfloat16 as ``ml_dtypes``'s, where that package is installed)."""
    if dt == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return dt
        return onp.dtype(ml_dtypes.bfloat16)
    try:
        return onp.dtype(dtype_name(dt))
    except TypeError:
        return dt


def _to_host(t):
    """An owned numpy copy of tensor ``t``: bfloat16 as ``ml_dtypes``'s
    bfloat16 where that package is installed (as the reference gives it),
    else widened to float32, which holds every bfloat16 value exactly."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        host = t.float().cpu().numpy()
        try:
            import ml_dtypes
        except ImportError:
            return host
        return host.astype(ml_dtypes.bfloat16)
    return onp.array(t.cpu().numpy(), copy=True)


def _keep_fresh(ref):
    def keep(g):   # before torch accumulates: the gradient this pass brings
        arr = ref()
        if arr is not None:
            arr._fresh = g

    return keep


def _settle(ref):
    def settle(t):   # after torch accumulated into t.grad
        arr = ref()
        if arr is None:
            return
        fresh, arr._fresh = arr._fresh, None
        if arr._grad_req == "write" and fresh is not None and \
                t.grad is not fresh:
            t.grad.copy_(fresh)
        elif arr._grad_req == "null":
            t.grad = None

    return settle


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_fresh", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            data = _as_tensor(data, None, None)
        self._data = data
        self._grad = None
        self._grad_req = "write"
        self._fresh = None

    # ------------------------------------------------------------------ core
    def _set_data(self, data):
        """Rebind the tensor (in-place semantics at the Python level). An
        array marked for gradients stays marked: the new tensor becomes the
        leaf and takes over the gradient buffer."""
        if self._grad is None:
            self._data = data
            return
        leaf = data.detach().requires_grad_(True)
        if self._grad_req != "null":
            leaf.grad = self.grad._data      # the buffer torch holds now
        self._data = leaf
        self._hook()

    def _hook(self):
        ref = weakref.ref(self)
        self._data.register_hook(_keep_fresh(ref))
        self._data.register_post_accumulate_grad_hook(_settle(ref))

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def ctx(self) -> Context:
        return context_of(self._data.device)

    context = ctx
    device = ctx

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return apply_op("transpose", self)

    # ------------------------------------------------------------- sync / io
    def wait_to_read(self):
        engine.wait_for_var(self._data)
        return self

    def wait_to_write(self):
        return self.wait_to_read()

    def asnumpy(self) -> onp.ndarray:
        """Blocking copy to the host, owned by the caller (reference:
        ``NDArray::SyncCopyToCPU``)."""
        try:
            return _to_host(self._data)
        except RuntimeError as e:
            raise MXNetError(str(e)) from e

    def item(self):
        if self.size != 1:
            raise ValueError(
                "can only convert an array of size 1 to a scalar")
        return self._data.detach().reshape(()).item()

    def asscalar(self):
        return self.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __index__(self):
        return int(self.item())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.item())
        raise ValueError("The truth value of an array with more than one "
                         "element is ambiguous.")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        body = repr(self.asnumpy())
        ctx = self.ctx
        if ctx.device_type != "cpu" and body.endswith(")"):
            return body[:-1] + f", ctx={ctx})"
        return body

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # NumPy dispatch protocol (reference :285-356): numpy functions on
    # NDArrays route to mx.np for the curated list; anything else runs on
    # host numpy over __array__
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        out = kwargs.pop("out", None)
        if out is not None:
            # numpy's in-place out= contract: run on the host into plain
            # buffers, then write the results back into the NDArray outs
            outs = out if isinstance(out, tuple) else (out,)
            host_outs = tuple(o.asnumpy() if isinstance(o, NDArray) else o
                              for o in outs)
            res = self._host_fallback(getattr(ufunc, method, ufunc), inputs,
                                      {**kwargs, "out": host_outs})
            res_items = res if isinstance(res, tuple) else (res,)
            filled = []
            for o, h, r in zip(outs, host_outs, res_items):
                if isinstance(o, NDArray):
                    o._set_data(torch.as_tensor(h, device=o._data.device))
                    filled.append(o)
                else:
                    filled.append(r if o is None else o)
            return filled[0] if len(filled) == 1 else tuple(filled)
        if method == "at" and isinstance(inputs[0], NDArray):
            # in-place scatter (onp.add.at(x, idx, v)): mutate a host copy,
            # then write it back into the NDArray
            target = inputs[0]
            host = target.asnumpy()
            self._host_fallback(getattr(ufunc, method),
                                (host,) + inputs[1:], kwargs)
            target._set_data(torch.as_tensor(host,
                                             device=target._data.device))
            return None
        if method != "__call__":
            return self._host_fallback(getattr(ufunc, method, ufunc),
                                       inputs, kwargs)
        from .. import numpy as _mxnp

        fn = getattr(_mxnp, ufunc.__name__, None)
        if fn is not None:
            try:
                return fn(*inputs, **kwargs)
            except TypeError:
                pass
        return self._host_fallback(ufunc, inputs, kwargs)

    def __array_function__(self, func, types, args, kwargs):
        from .. import numpy as _mxnp

        if func.__name__ in _NP_DISPATCH_HANDLED:
            fn = getattr(_mxnp, func.__name__, None)
            if fn is not None:
                return fn(*args, **kwargs)
        return self._host_fallback(func, args, kwargs)

    @staticmethod
    def _host_fallback(func, args, kwargs):
        def conv(x):
            if isinstance(x, NDArray):
                return x.asnumpy()
            if isinstance(x, (list, tuple)):
                return type(x)(conv(v) for v in x)
            return x

        return func(*conv(list(args)),
                    **{k: conv(v) for k, v in kwargs.items()})

    # ----------------------------------------------------------- conversion
    def astype(self, dtype, copy=True):
        dt = canonical_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return apply_op("astype", self, dtype=dtype_name(dt))

    def copy(self):
        return apply_op("copy", self)

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        if isinstance(other, Context):
            return self.as_in_ctx(other)
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_ctx(self, ctx):
        """The array on ``ctx`` (itself if it is there already); the
        transfer is the identity for autograd."""
        dev = resolve_device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(self._data.to(dev))

    as_in_context = as_in_ctx
    to_device = as_in_ctx

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and mark the array as a gradient
        sink (reference :407; ``stype`` accepted and ignored: gradients are
        dense)."""
        _ag.mark_variables([self], [NDArray(torch.zeros_like(self._data))],
                           [grad_req])

    @property
    def grad(self):
        g = self._grad
        if g is not None and self._grad_req != "null" and \
                self._data.is_leaf:
            t = self._data.grad
            if t is not None and t is not g._data:
                g._data = t
        return g

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad], retain_graph, train_mode)

    def zero_grad(self):
        if self._grad is not None:
            self.grad._data.zero_()

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key):
        return _indexing.getitem(self, key)

    def __setitem__(self, key, value):
        _indexing.setitem(self, key, value)

    def take(self, indices, axis=None, mode="clip"):
        return apply_op("take", self, indices, axis=axis, mode=mode)

    # ------------------------------------------------------- shape manip
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return apply_op("reshape", self, newshape=shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return apply_op("transpose", self, axes=axes if axes else None)

    def swapaxes(self, a1, a2):
        return apply_op("swapaxes", self, axis1=a1, axis2=a2)

    def flatten(self):
        return self.reshape((-1,))

    def ravel(self):
        return self.reshape((-1,))

    def squeeze(self, axis=None):
        return apply_op("squeeze", self, axis=axis)

    def expand_dims(self, axis):
        return apply_op("expand_dims", self, axis=axis)

    def broadcast_to(self, shape):
        return apply_op("broadcast_to", self, shape=tuple(shape))

    def tile(self, reps):
        return apply_op("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return apply_op("repeat", self, repeats=repeats, axis=axis)

    def split(self, indices_or_sections, axis=0):
        return apply_op("split", self,
                        indices_or_sections=indices_or_sections, axis=axis)

    # --------------------------------------------------------- reductions
    def sum(self, axis=None, dtype=None, keepdims=False, **kw):
        return apply_op("sum", self, axis=axis, dtype=_dt(dtype),
                        keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False, **kw):
        return apply_op("mean", self, axis=axis, dtype=_dt(dtype),
                        keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return apply_op("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return apply_op("min", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return apply_op("prod", self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False, **kw):
        return apply_op("std", self, axis=axis, ddof=ddof,
                        keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False, **kw):
        return apply_op("var", self, axis=axis, ddof=ddof,
                        keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False, **kw):
        return apply_op("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False, **kw):
        return apply_op("argmin", self, axis=axis, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return apply_op("cumsum", self, axis=axis, dtype=_dt(dtype))

    def clip(self, a_min=None, a_max=None):
        return apply_op("clip", self, a_min=a_min, a_max=a_max)

    def round(self, decimals=0):
        return apply_op("round", self, decimals=decimals)

    def abs(self):
        return apply_op("abs", self)

    def dot(self, other):
        return apply_op("dot", self, other)

    def norm(self, ord=None, axis=None, keepdims=False):
        return apply_op("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def tostype(self, stype):
        """This array in storage ``stype``: ``'default'`` (itself),
        ``'csr'`` (2-D) or ``'row_sparse'``, on its device."""
        if stype == "default":
            return self
        from . import sparse

        if stype == "csr":
            return sparse.csr_matrix(self, dtype=self._data.dtype)
        if stype == "row_sparse":
            return sparse.row_sparse_array(self, dtype=self._data.dtype)
        raise MXNetError(f"unknown storage type {stype!r}")

    # --------------------------------------------------------- arithmetic
    def _binop(self, name, other, reverse=False):
        if isinstance(other, torch.Tensor):
            other = NDArray(other)
        if isinstance(other, NDArray) or onp.isscalar(other) or isinstance(
                other, (onp.ndarray, list, tuple)):
            if isinstance(other, (onp.ndarray, list, tuple)):
                other = NDArray(_as_tensor(other, None, self._data.device))
            a, b = (other, self) if reverse else (self, other)
            return apply_op(name, a, b)
        return NotImplemented

    def __add__(self, o):
        return self._binop("add", o)

    def __radd__(self, o):
        return self._binop("add", o, True)

    def __sub__(self, o):
        return self._binop("subtract", o)

    def __rsub__(self, o):
        return self._binop("subtract", o, True)

    def __mul__(self, o):
        return self._binop("multiply", o)

    def __rmul__(self, o):
        return self._binop("multiply", o, True)

    def __truediv__(self, o):
        return self._binop("true_divide", o)

    def __rtruediv__(self, o):
        return self._binop("true_divide", o, True)

    def __floordiv__(self, o):
        return self._binop("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._binop("floor_divide", o, True)

    def __mod__(self, o):
        return self._binop("mod", o)

    def __rmod__(self, o):
        return self._binop("mod", o, True)

    def __pow__(self, o):
        return self._binop("power", o)

    def __rpow__(self, o):
        return self._binop("power", o, True)

    def __matmul__(self, o):
        return self._binop("matmul", o)

    def __rmatmul__(self, o):
        return self._binop("matmul", o, True)

    def __neg__(self):
        return apply_op("negative", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply_op("abs", self)

    def __invert__(self):
        return apply_op("invert", self)

    # in-place: rebind (reference :542-566)
    def __iadd__(self, o):
        return self._inplace("add", o)

    def __isub__(self, o):
        return self._inplace("subtract", o)

    def __imul__(self, o):
        return self._inplace("multiply", o)

    def __itruediv__(self, o):
        return self._inplace("true_divide", o)

    def _inplace(self, name, o):
        if _ag.is_recording() and self._data.requires_grad:
            raise MXNetError(
                "in-place operations on arrays participating in a recorded "
                "graph are not allowed inside autograd.record()")
        res = self._binop(name, o)
        self._set_data(res._data.to(self._data.dtype))
        return self

    # comparisons
    def __eq__(self, o):
        return self._binop("equal", o)

    def __ne__(self, o):
        return self._binop("not_equal", o)

    def __lt__(self, o):
        return self._binop("less", o)

    def __le__(self, o):
        return self._binop("less_equal", o)

    def __gt__(self, o):
        return self._binop("greater", o)

    def __ge__(self, o):
        return self._binop("greater_equal", o)

    def __hash__(self):
        return id(self)

    # torch functions given an NDArray (``tensor + ndarray``,
    # ``torch.tanh(ndarray)``): run on the tensors, results as NDArrays
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return wrap(func(*unwrap(args), **{k: unwrap(v) for k, v in
                                           (kwargs or {}).items()}))


def _dt(dtype):
    return None if dtype is None else dtype_name(canonical_dtype(dtype))


def _as_tensor(obj, dtype, device):
    """A new tensor of ``obj`` (array-like, NDArray or tensor) on
    ``device`` (None: the current context), with the reference's dtypes:
    64-bit inputs narrowed, Python ints int32 and floats float32, unless
    ``dtype`` says otherwise."""
    if isinstance(obj, NDArray):
        obj = obj._data
    dt = canonical_dtype(dtype)
    dev = resolve_device(device)
    if isinstance(obj, torch.Tensor):
        t = obj.detach().to(device=dev, dtype=dt, copy=True)
        return narrow(t)
    host = onp.asarray(obj)
    if host.dtype == object:
        raise MXNetError("object arrays cannot become an NDArray")
    store = _consts.store
    if store is not None and dev.type == "cuda":
        key = (host.dtype.str, host.shape, host.tobytes(), dt, dev)
        t = store.get(key)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise MXNetError(
                    "an array made from host data of shape "
                    f"{host.shape} first appears while a CUDA graph "
                    "captures: the body made other host constants at its "
                    "warm call")
            t = store[key] = _host_tensor(host, dt, dev)
        return t
    return _host_tensor(host, dt, dev)


def _host_tensor(host, dt, dev):
    if dt is None:
        t = torch.from_numpy(onp.array(host, copy=True)) \
            if host.dtype.name != "bfloat16" else \
            torch.from_numpy(host.astype(onp.float32)).to(torch.bfloat16)
        return narrow(t).to(dev)
    return torch.tensor(host.astype(onp.float32)
                        if host.dtype.name == "bfloat16" else host,
                        device=dev).to(dt)


class _Consts(threading.local):
    store = None


_consts = _Consts()


@contextlib.contextmanager
def host_constants(store):
    """Inside the block, arrays made from host data on the card are taken
    from ``store`` (a dict, by value) and made into it when missing; one
    first made while a CUDA graph captures raises (see the module
    docstring)."""
    prev, _consts.store = _consts.store, store
    try:
        yield
    finally:
        _consts.store = prev


def unwrap(x):
    """``x`` with every NDArray (at any depth of tuples and lists) replaced
    by its tensor."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(unwrap(v) for v in x)
    return x


def wrap(x):
    """``x`` with every tensor (at any depth of tuples and lists) wrapped
    into an NDArray, without a copy."""
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (tuple, list)):
        return type(x)(wrap(v) for v in x)
    return x


def array(obj, dtype=None, ctx=None, device=None):
    """An NDArray from array-like data (reference :593), on ``device`` or
    ``ctx`` (None: the current context)."""
    return NDArray(_as_tensor(obj, dtype, device or ctx))


def from_torch(t) -> NDArray:
    """Wrap an existing tensor without a copy (the reference's
    ``from_jax``)."""
    return NDArray(t)


# bound here, not in the methods: ops.indexing imports this module's
# package, so it is imported once both exist
from ..ops import indexing as _indexing  # noqa: E402
