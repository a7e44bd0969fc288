"""Operator registry and the single imperative dispatch chokepoint of the port.

Counterpart of ``mxnet_tpu/ops/registry.py:55-316``. An :class:`Op` is a
name plus ``make_fn(**attrs)`` returning a function over ``torch.Tensor``
operands; :meth:`Op.fn` caches one such function per set of attributes.
``invoke(op, inputs, attrs)`` is the one path from ``mx.np``, ``mx.npx`` and
``NDArray`` methods to compute: it unwraps the NDArrays, runs the op's
function and wraps the results. The tensor-level doors of
:mod:`mxnet_tpu_torch.ops.nn` (the functions GPT, the losses, the compiled
step and the decode programs call) resolve the same cached functions, so
one definition serves both.

The reference's three execution modes map onto torch as follows:

- eager: the function runs and torch queues its kernels;
- recorded: under ``autograd.record()`` the function runs with torch's
  grad mode on and torch's autograd keeps the tape. Outside ``record()``
  (and inside ``pause()``) it runs with grad mode off, so nothing is
  recorded, as in the reference. Ops registered ``differentiable=False``
  never record;
- traced: inside a deferred-compute trace
  (:mod:`mxnet_tpu_torch._deferred_compute`) ``invoke`` runs the op with
  recording suspended and appends one node to the trace's Symbol, as the
  reference's ``invoke`` does.

AMP is cast here and only here, as in the reference: while AMP is on,
:func:`invoke` (and the tensor-level doors) add the synthetic ``__amp__``
attribute to ops named in ``amp.MXU_OPS``, and :meth:`Op.fn` wraps such a
function so that it casts its float32 tensor operands to the AMP dtype at
entry (:func:`_amp_wrap`).

There is no ``jax.jit`` of each op and no compile watchdog: torch runs ops
eagerly. Results with a 64-bit dtype are narrowed to the reference's 32-bit
ones (:func:`mxnet_tpu_torch.base.narrow`).
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import amp as _amp
from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError, cast, narrow, to_dtype
from ..context import resolve_device

__all__ = ["Op", "register", "register_alias", "get_op", "list_ops",
           "invoke", "apply_op"]

_OPS: dict[str, "Op"] = {}


def _freeze(value):
    """Make attrs hashable (lists->tuples, dicts->sorted item tuples)."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, onp.ndarray):
        return (value.shape, str(value.dtype), value.tobytes())
    return value


class Op:
    """A registered operator: a factory of functions on tensors, and its
    metadata (reference :55)."""

    __slots__ = ("name", "_make_fn", "_fn_cache", "needs_rng", "nout",
                 "sym_nout", "differentiable", "eager_only")

    def __init__(self, name, make_fn, needs_rng: bool = False, nout=1,
                 differentiable: bool = True, sym_nout=None,
                 eager_only: bool = False):
        self.name = name
        self._make_fn = make_fn
        self._fn_cache: dict = {}
        # needs_rng: the function takes a torch.Generator of its operands'
        # device as its first argument (reference: the PRNG key operand)
        self.needs_rng = needs_rng
        self.nout = nout
        # sym_nout: a function of the attributes giving the output entries
        # of a Symbol node of this op, for an op whose count follows them
        # (``rnn``: 3 for LSTM, else 2); None: one entry. The Symbol layer
        # reads this, never ``nout``.
        self.sym_nout = sym_nout
        # declared at registration (reference: presence of FGradient): a
        # non-differentiable op runs with grad mode off and never records
        self.differentiable = differentiable
        # eager_only: an op whose output shape follows its operands' values
        # (reference: registered ``jit=False``); its function raises inside
        # a compiled program (:func:`_eager_only`)
        self.eager_only = eager_only

    def fn(self, **attrs):
        """The function of this op for ``attrs``, made once per set of
        attributes and cached. The synthetic ``__amp__`` attribute (set by
        :func:`invoke` while AMP is on) wraps it with the input casts."""
        key = _freeze(attrs) if attrs else ()
        f = self._fn_cache.get(key)
        if f is None:
            attrs = dict(attrs)
            amp_dt = attrs.pop("__amp__", None)
            f = self._make_fn(**attrs)
            if amp_dt is not None:
                f = _amp_wrap(f, amp_dt)
            if self.eager_only:
                f = _eager_only(f, self.name)
            self._fn_cache[key] = f
        return f

    def __repr__(self):
        return f"Op({self.name})"


def register(name, make_fn=None, *, needs_rng=False, nout=1,
             differentiable=True, sym_nout=None, eager_only=False):
    """Register an operator. Usable directly or as a decorator on
    ``make_fn``; a name registered twice raises :class:`MXNetError`."""

    def _do(mf):
        if name in _OPS:
            raise MXNetError(f"op '{name}' already registered")
        op = Op(name, mf, needs_rng=needs_rng, nout=nout,
                differentiable=differentiable, sym_nout=sym_nout,
                eager_only=eager_only)
        _OPS[name] = op
        return op

    if make_fn is None:
        return _do
    return _do(make_fn)


def register_alias(alias: str, target: str):
    """Register ``alias`` as another name of op ``target`` (the same
    :class:`Op`, so the same cache)."""
    if alias in _OPS:
        raise MXNetError(f"op '{alias}' already registered")
    _OPS[alias] = get_op(target)
    return _OPS[alias]


def get_op(name: str) -> Op:
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"op '{name}' is not registered") from None


def list_ops():
    return sorted(_OPS)


def amp_attrs(op, attrs):
    """``attrs`` with ``__amp__`` added while AMP is on and ``op`` is one of
    ``amp.MXU_OPS`` (reference :215-217)."""
    attrs = attrs or {}
    if _amp.is_enabled() and op.name in _amp.MXU_OPS and \
            "__amp__" not in attrs:
        return {**attrs, "__amp__": _amp.target_dtype()}
    return attrs


def _device_of(datas, attrs):
    """Where an op that draws random numbers draws: its first tensor
    operand's device, else the device its ``ctx`` attribute names (the
    current context when None), as a sampler without tensor operands
    makes its values there."""
    for d in datas:
        if isinstance(d, torch.Tensor):
            return d.device
    return resolve_device((attrs or {}).get("ctx"))


def invoke(op: Op, inputs, attrs=None, out=None):
    """Run ``op`` on ``inputs`` (NDArrays, tensors or Python scalars);
    returns an NDArray, or a tuple of them for an op with several outputs.
    ``out`` (an NDArray or a sequence of them, one a result) receives the
    results by rebinding, and is returned."""
    if _dc._state.ctx is not None:
        # deferred compute: run with recording suspended, record one node
        attrs = amp_attrs(op, attrs)
        with _dc.suspend():
            res = invoke(op, inputs, attrs, out)
        _dc.record(op, attrs, inputs, res)
        return res
    NDArray = _nd.NDArray
    fn = op.fn(**amp_attrs(op, attrs)) if attrs or _amp.is_enabled() \
        else op.fn()
    datas = [x._data if isinstance(x, NDArray) else x for x in inputs]
    if op.needs_rng:
        datas.insert(0, _random.generator(_device_of(datas, attrs)))
    rec = op.differentiable and _ag.is_recording()
    try:
        # grad mode as recording says; it matters only where an operand
        # takes gradients, so the common case skips the mode switch
        if torch.is_grad_enabled() == rec or not rec and not any(
                isinstance(d, torch.Tensor) and d.requires_grad
                for d in datas):
            res = fn(*datas)
        else:
            with torch.set_grad_enabled(rec):
                res = fn(*datas)
    except (MXNetError, TypeError, ValueError, ZeroDivisionError,
            IndexError):
        raise
    except Exception as e:  # noqa: BLE001 — normalise torch's errors
        raise MXNetError(f"op '{op.name}' failed: {e}") from e
    multi = isinstance(res, (tuple, list))
    outputs = tuple(NDArray(narrow(t)) for t in res) if multi else \
        NDArray(narrow(res))
    if out is None:
        return outputs
    # rebind each destination (reference ``_write_out``): an array marked
    # for gradients stays marked (a weight written back by an update op)
    if multi:
        for dst, src in zip(out, outputs):
            dst._set_data(src._data)
        return out
    if isinstance(out, (tuple, list)):
        out = out[0]
    out._set_data(outputs._data)
    return out


def apply_op(name: str, *inputs, **attrs):
    """Invoke a registered op by name (``out=`` as :func:`invoke`'s)."""
    out = attrs.pop("out", None)
    return invoke(get_op(name), inputs, attrs, out=out)


def _eager_only(f, name):
    """``f`` raising :class:`MXNetError` inside a compiled program (a
    hybridized block's or an Executor's CachedOp body, or a CUDA graph
    capture), where the reference's ``jit`` of the graph refuses an op whose
    output shape follows its operands' values; eagerly, ``f`` itself."""
    def guarded(*args):
        from ..cached_op import is_inlined

        if is_inlined():
            raise MXNetError(
                f"op '{name}' has an output shape that follows its operands' "
                "values: it runs eagerly only, not inside a hybridized block, "
                "an Executor or a CUDA graph capture")
        return f(*args)

    return guarded


def _amp_wrap(f, dtype_name):
    """``f`` with every float32 tensor operand cast to the AMP dtype
    ``dtype_name`` at entry; other operands (ints, bools, masks of other
    dtypes, None, scalars) as they are (reference :283-297). The casts are
    the reference's ``astype`` (:func:`~mxnet_tpu_torch.base.cast`: NaN past
    float8_e4m3fn's range) and differentiable: gradients of float32 inputs
    come back float32."""
    tgt = to_dtype(_amp.resolve_dtype(dtype_name))

    def wrapped(*args):
        return f(*[cast(a, tgt) if isinstance(a, torch.Tensor) and
                   a.dtype == torch.float32 else a for a in args])

    return wrapped


# NDArray's module imports this one: bind it once both exist, so invoke
# reads the class by one attribute lookup and imports nothing per call;
# the recorder imports the Symbol IR, which imports this module
from ..ndarray import ndarray as _nd  # noqa: E402
from .. import _deferred_compute as _dc  # noqa: E402
