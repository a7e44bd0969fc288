"""Deferred compute: trace a forward into a Symbol graph.

Counterpart of ``mxnet_tpu/_deferred_compute.py``. The forward runs eagerly
on real tensors (real values, real shapes) while every op it runs appends a
:class:`~mxnet_tpu_torch.symbol.SymNode`; the Symbol that results is what
``export`` writes and what a graph pass (``optimize_for``) rewrites.

The reference's bodies reach compute only through ``registry.invoke``. The
port's bodies are torch code, so the recorder listens in three places:

- ``ops.registry.invoke`` (``mx.np``, ``mx.npx``, NDArray methods) records
  one node per call;
- the tensor-level doors of :mod:`mxnet_tpu_torch.ops.nn` record one node
  per door call, with the op's own function run under :func:`suspend`;
- a ``torch.overrides.TorchFunctionMode``, pushed on the tracing thread for
  the trace's length only, maps the raw torch calls that blocks make on
  traced tensors onto registry ops under the reference's names and
  attributes (``+`` -> ``add``, ``reshape``/``view`` -> ``reshape``,
  ``unsqueeze`` -> ``expand_dims``, ``__getitem__`` -> ``slice_key``,
  ``<`` -> ``less``, ``.to(dtype)`` -> ``astype``, ``.t()`` ->
  ``transpose``, ``chunk`` -> ``split``, ...; see ``_RULES``). The node runs
  the op's function, so the eager values are the graph's.

Rules kept by the recorder:

- a tensor made without traced inputs (``torch.arange(T)``) becomes a
  ``_const`` node where a recorded op consumes it (reference :100-120);
- a torch call on a traced tensor that has no rule raises
  :class:`MXNetError` naming the function; it is never baked in as a
  constant. Reading metadata (shape, dtype, device) passes;
- an in-place write to a traced tensor (or of one into another tensor)
  raises; a block that updates state (BatchNorm's running statistics)
  registers the update with :func:`register_aux_update` instead, and the
  compiled program writes it after each call;
- RNG ops (dropout) mark the trace as drawing; the executor gives such a
  node the port's generator of its device on every call.

The trace state is thread-local and the mode lives on the tracing thread's
mode stack, so a serving thread replaying programs meanwhile sees neither.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.overrides import TorchFunctionMode

from .base import MXNetError, dtype_name
from .symbol.symbol import Literal, SymNode

__all__ = ["is_tracing", "context", "suspend", "set_variable",
           "register_aux_update", "call"]


class _TraceCtx:
    def __init__(self):
        self.uses_rng = False
        self.aux_updates = []   # [(target tensor, source entry)]
        self.entries = {}       # id(tensor) -> (SymNode, out_idx)
        self.keep = []          # the tensors those ids belong to


class _State(threading.local):
    ctx = None


_state = _State()


def is_tracing() -> bool:
    return _state.ctx is not None


def current() -> _TraceCtx:
    if _state.ctx is None:
        raise MXNetError("no deferred-compute trace is active")
    return _state.ctx


@contextlib.contextmanager
def context():
    """Enter tracing mode on this thread (reference: ``dc.context``)."""
    if _state.ctx is not None:
        raise MXNetError("deferred compute traces cannot nest")
    ctx = _state.ctx = _TraceCtx()
    try:
        with _Recorder():
            yield ctx
    finally:
        _state.ctx = None


@contextlib.contextmanager
def suspend():
    """Leave tracing mode for the block (an op's own function runs here)."""
    prev, _state.ctx = _state.ctx, None
    try:
        yield
    finally:
        _state.ctx = prev


def _bind(ctx, t, entry):
    ctx.entries[id(t)] = entry
    ctx.keep.append(t)


def set_variable(t, name: str) -> SymNode:
    """Mark a tensor (or NDArray) as the graph input ``name``; its shape is
    kept as ``__shape__`` for shape-sensitive passes."""
    t = getattr(t, "_data", t)
    node = SymNode(name=name, attr_dict={"__shape__": str(tuple(t.shape))})
    _bind(current(), t, (node, 0))
    return node


def register_aux_update(target, source) -> None:
    """Write ``source`` (a traced tensor) into ``target`` after every call
    of the compiled program (BatchNorm's running statistics)."""
    ctx = current()
    entry = ctx.entries.get(id(source))
    if entry is None:
        raise MXNetError("aux update source was not produced by a traced op")
    ctx.aux_updates.append((target, entry))


def _input_entry(ctx, x):
    x = getattr(x, "_data", x)
    if isinstance(x, torch.Tensor):
        entry = ctx.entries.get(id(x))
        if entry is None:
            # constant capture: a tensor the trace did not produce
            entry = (SymNode(value=x.detach().clone()), 0)
            _bind(ctx, x, entry)
        return entry
    return Literal(x)


def record(op, attrs, inputs, outputs) -> None:
    """Append a node for ``op`` applied to ``inputs`` (tensors, NDArrays,
    Python values) that gave ``outputs``."""
    ctx = current()
    if op.name == "slice_key" and any(
            isinstance(getattr(x, "_data", x), torch.Tensor) and
            getattr(x, "_data", x).dtype == torch.bool for x in inputs[1:]):
        raise MXNetError("boolean-mask indexing has a data-dependent shape "
                         "and cannot be traced into a graph")
    entries = [_input_entry(ctx, x) for x in inputs]
    if op.needs_rng:
        ctx.uses_rng = True
    outs = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
    node = SymNode(op=op, attrs=dict(attrs), inputs=entries, nout=len(outs))
    for i, o in enumerate(outs):
        _bind(ctx, getattr(o, "_data", o), (node, i))


def call(op, attrs, fn, args):
    """``fn(*args)`` (``op``'s function for ``attrs``) with recording
    suspended inside, recorded as one node; an RNG op's leading generator
    operand is not a graph input."""
    with suspend():
        out = fn(*args)
    record(op, attrs, args[1:] if op.needs_rng else args, out)
    return out


# ---------------------------------------------------------------------------
# the torch-function recorder
# ---------------------------------------------------------------------------
def _traced_in(ctx, args, kwargs):
    ids = ctx.entries
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            if id(a) in ids:
                return True
        elif isinstance(a, (tuple, list)):
            for b in a:
                if isinstance(b, torch.Tensor) and id(b) in ids:
                    return True
    return False


def _fname(func):
    name = getattr(func, "__name__", None) or repr(func)
    if name in ("__get__", "__set__"):
        owner = getattr(getattr(func, "__self__", None), "__name__", "?")
        name = ("get:" if name == "__get__" else "set:") + owner
    return name


# metadata reads and other calls that make no value of the graph
_PASS = frozenset({
    "size", "dim", "ndimension", "numel", "nelement", "element_size",
    "is_floating_point", "is_complex", "is_contiguous", "data_ptr",
    "stride", "storage_offset", "get_device", "__len__", "__hash__",
    "__repr__", "__str__", "__format__", "untyped_storage", "retain_grad",
    "has_names", "is_inference",
})
# calls whose result is their operand (the same graph entry)
_IDENTITY = frozenset({"contiguous", "get:data", "requires_grad_"})
_INPLACE_DUNDER = frozenset({
    "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__",
    "__idiv__", "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
    "__ior__", "__ixor__", "__ilshift__", "__irshift__", "__imatmul__"})


def _inplace(name):
    return name in _INPLACE_DUNDER or name.startswith("set:") or (
        name.endswith("_") and not name.startswith("_"))


def _shape_arg(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = shape[0]
    return tuple(int(s) for s in shape)


def _bin(op):
    def rule(a, b, *, alpha=1):
        if alpha != 1:
            raise MXNetError(f"{op} with alpha={alpha} has no recorded form")
        return op, [a, b], {}

    return rule


def _rbin(op):
    return lambda a, b: (op, [b, a], {})


def _div(a, b, *, rounding_mode=None):
    if rounding_mode is None:
        return "true_divide", [a, b], {}
    if rounding_mode == "floor":
        return "floor_divide", [a, b], {}
    raise MXNetError(f"division with rounding_mode={rounding_mode!r} has no "
                     "recorded form")


def _unary(op):
    return lambda a: (op, [a], {})


def _reshape(x, *shape):
    return "reshape", [x], {"newshape": _shape_arg(shape)}


def _flatten(x, start_dim=0, end_dim=-1):
    if end_dim not in (-1, x.dim() - 1) or start_dim not in (0, 1):
        raise MXNetError(f"flatten(start_dim={start_dim}, end_dim={end_dim}) "
                         "has no recorded form")
    if start_dim == 1:
        return "flatten", [x], {}
    return "reshape", [x], {"newshape": (-1,)}


def _transpose_2(x, dim0, dim1):
    return "swapaxes", [x], {"axis1": int(dim0), "axis2": int(dim1)}


def _permute(x, *dims):
    return "transpose", [x], {"axes": _shape_arg(dims)}


def _t(x):
    return "transpose", [x], {"axes": tuple(reversed(range(x.dim())))}


def _squeeze(x, dim=None):
    return "squeeze", [x], {"axis": dim if dim is None or isinstance(
        dim, int) else tuple(dim)}


def _expand(x, *sizes):
    sizes = _shape_arg(sizes)
    full = tuple(x.shape[i - (len(sizes) - x.dim())] if s == -1 else s
                 for i, s in enumerate(sizes))
    return "broadcast_to", [x], {"shape": full}


def _chunk(x, chunks, dim=0):
    if x.shape[dim] % chunks:
        raise MXNetError(f"chunk({chunks}) of an extent of {x.shape[dim]} "
                         "has no recorded form (uneven parts)")
    return "split", [x], {"indices_or_sections": int(chunks), "axis": dim}


def _split(x, split_size_or_sections, dim=0):
    s = split_size_or_sections
    if isinstance(s, int):
        if x.shape[dim] % s:
            raise MXNetError("split into uneven parts has no recorded form")
        return "split", [x], {"indices_or_sections": x.shape[dim] // s,
                              "axis": dim}
    cuts, at = [], 0
    for n in list(s)[:-1]:
        at += int(n)
        cuts.append(at)
    return "split", [x], {"indices_or_sections": tuple(cuts), "axis": dim}


def _cat(tensors, dim=0, **kw):
    return "concatenate", list(tensors), {"axis": dim}


def _stack(tensors, dim=0, **kw):
    return "stack", list(tensors), {"axis": dim}


def _getitem(x, key):
    from .ops.indexing import _freeze_key

    spec, arrays = _freeze_key(key, x.device)
    return "slice_key", [x, *arrays], {"spec": spec}


def _where(cond, x, y):
    return "where", [cond, x, y], {}


def _masked_fill(x, mask, value):
    return "where", [mask, value, x], {}


def _astype(dtype):
    return lambda x: ("astype", [x], {"dtype": dtype})


def _to(x, *args, **kwargs):
    dtype = kwargs.get("dtype")
    device = kwargs.get("device")
    for a in args:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, torch.Tensor):
            dtype, device = a.dtype, a.device
        elif isinstance(a, (str, torch.device)):
            device = a
    if device is not None and torch.device(device) != x.device:
        raise MXNetError(f"moving a traced tensor to {device} inside a "
                         "trace has no recorded form")
    return "astype", [x], {"dtype": dtype_name(dtype or x.dtype)}


def _type_as(x, other):
    return "astype", [x], {"dtype": dtype_name(other.dtype)}


def _reduce(op):
    def rule(x, dim=None, keepdim=False, *, dtype=None):
        attrs = {"axis": dim if dim is None or isinstance(dim, int)
                 else tuple(dim), "keepdims": keepdim}
        if dtype is not None:
            attrs["dtype"] = dtype_name(dtype)
        return op, [x], attrs

    return rule


def _softmax(op):
    def rule(x, dim=None, dtype=None, **kw):
        if dtype is not None:
            raise MXNetError(f"{op} with dtype= has no recorded form")
        return op, [x], {"axis": -1 if dim is None else dim}

    return rule


def _clamp(x, min=None, max=None):  # noqa: A002 — torch's names
    return "clip", [x], {"a_min": min, "a_max": max}


def _einsum(eq, *operands):
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = operands[0]
    return "einsum", list(operands), {"subscripts": eq}


def _gelu(x, approximate="none"):
    return "leaky_relu", [x], {
        "act_type": "gelu" if approximate == "none" else "gelu_tanh",
        "slope": 0.25}


def _linear(x, weight, bias=None):
    if bias is None:
        return "fully_connected", [x, weight], {"no_bias": True,
                                                "flatten": False}
    return "fully_connected", [x, weight, bias], {"no_bias": False,
                                                  "flatten": False}


_RULES = {}
for _names, _rule in [
        (("add", "__add__", "__radd__"), _bin("add")),
        (("sub", "subtract", "__sub__"), _bin("subtract")),
        (("rsub", "__rsub__"), _rbin("subtract")),
        (("mul", "multiply", "__mul__", "__rmul__"), _bin("multiply")),
        (("div", "divide", "true_divide", "__truediv__", "__div__"), _div),
        (("__rtruediv__", "__rdiv__"), _rbin("true_divide")),
        (("floor_divide", "__floordiv__"), _bin("floor_divide")),
        (("__rfloordiv__",), _rbin("floor_divide")),
        (("remainder", "__mod__"), _bin("mod")),
        (("pow", "__pow__"), _bin("power")),
        (("__rpow__",), _rbin("power")),
        (("matmul", "__matmul__", "mm", "bmm"), _bin("matmul")),
        (("__rmatmul__",), _rbin("matmul")),
        (("lt", "less", "__lt__"), _bin("less")),
        (("le", "less_equal", "__le__"), _bin("less_equal")),
        (("gt", "greater", "__gt__"), _bin("greater")),
        (("ge", "greater_equal", "__ge__"), _bin("greater_equal")),
        (("eq", "__eq__"), _bin("equal")),
        (("ne", "not_equal", "__ne__"), _bin("not_equal")),
        (("maximum",), _bin("maximum")),
        (("minimum",), _bin("minimum")),
        (("__and__", "__rand__", "bitwise_and"), _bin("bitwise_and")),
        (("__or__", "__ror__", "bitwise_or"), _bin("bitwise_or")),
        (("__xor__", "__rxor__", "bitwise_xor"), _bin("bitwise_xor")),
        (("logical_and",), _bin("logical_and")),
        (("logical_or",), _bin("logical_or")),
        (("neg", "negative", "__neg__"), _unary("negative")),
        (("abs", "__abs__"), _unary("abs")),
        (("logical_not", "__invert__"), _unary("logical_not")),
        (("reshape", "view"), _reshape),
        (("flatten",), _flatten),
        (("unsqueeze",), lambda x, dim: ("expand_dims", [x],
                                         {"axis": int(dim)})),
        (("squeeze",), _squeeze),
        (("transpose", "swapaxes", "swapdims"), _transpose_2),
        (("permute",), _permute),
        (("t", "get:T"), _t),
        (("get:mT",), lambda x: _transpose_2(x, -2, -1)),
        (("expand",), _expand),
        (("expand_as",), lambda x, o: ("broadcast_to", [x],
                                       {"shape": tuple(o.shape)})),
        (("chunk",), _chunk),
        (("split",), _split),
        (("cat", "concat", "concatenate"), _cat),
        (("stack",), _stack),
        (("__getitem__",), _getitem),
        (("where",), _where),
        (("masked_fill",), _masked_fill),
        (("to",), _to),
        (("type_as",), _type_as),
        (("float",), _astype("float32")),
        (("double",), _astype("float64")),
        (("half",), _astype("float16")),
        (("bfloat16",), _astype("bfloat16")),
        (("int",), _astype("int32")),
        (("long",), _astype("int64")),
        (("bool",), _astype("bool")),
        (("clone",), _unary("copy")),
        (("detach",), _unary("stop_gradient")),
        (("sum",), _reduce("sum")),
        (("mean",), _reduce("mean")),
        (("amax",), _reduce("max")),
        (("amin",), _reduce("min")),
        (("softmax",), _softmax("softmax")),
        (("log_softmax",), _softmax("log_softmax")),
        (("clamp", "clip"), _clamp),
        (("clamp_min",), lambda x, m: _clamp(x, min=m)),
        (("clamp_max",), lambda x, m: _clamp(x, max=m)),
        (("einsum",), _einsum),
        (("gelu",), _gelu),
        (("linear",), _linear),
        (("ones_like",), lambda x, **kw: ("ones_like", [x], {})),
        (("zeros_like",), lambda x, **kw: ("zeros_like", [x], {})),
        (("relu",), lambda x, *a, **kw: ("activation", [x],
                                         {"act_type": "relu"})),
        (("sigmoid",), lambda x: ("activation", [x],
                                  {"act_type": "sigmoid"})),
        (("tanh",), lambda x: ("tanh", [x], {})),
]:
    for _n in _names:
        _RULES[_n] = _rule
for _n in ("exp", "log", "sqrt", "sin", "cos", "sign", "floor",
           "ceil", "square", "reciprocal", "log1p", "expm1", "erf",
           "isnan", "isinf", "isfinite"):
    _RULES.setdefault(_n, _unary(_n))


def _torch_call(ctx, func, args, kwargs):
    name = _fname(func)
    if name in _PASS or (name.startswith("get:") and name not in _RULES
                         and name not in _IDENTITY):
        return func(*args, **kwargs)
    if name in _IDENTITY:
        out = func(*args, **kwargs)
        _bind(ctx, out, ctx.entries[id(args[0])])
        return out
    if _inplace(name) or kwargs.get("out") is not None:
        raise MXNetError(
            f"torch '{name}' writes in place to a traced tensor (or a traced "
            "value into a tensor); a traced graph has no in-place writes")
    rule = _RULES.get(name)
    if rule is None:
        raise MXNetError(
            f"torch '{name}' on a traced tensor has no registered op to "
            "record it as; call it through mx.np / mx.npx or an ops.nn door")
    try:
        op_name, inputs, attrs = rule(*args, **kwargs)
    except TypeError as e:
        raise MXNetError(f"torch '{name}': these arguments have no recorded "
                         f"form ({e})") from e
    from .ops.registry import get_op

    op = get_op(op_name)
    return call(op, attrs, op.fn(**attrs), inputs)


def _has_nd(args, kwargs, nd):
    for a in (*args, *kwargs.values()):
        if isinstance(a, nd) or isinstance(a, (tuple, list)) and any(
                isinstance(b, nd) for b in a):
            return True
    return False


class _Recorder(TorchFunctionMode):
    """Records the raw torch calls made on traced tensors (module
    docstring); everything else passes through untouched. A call given
    NDArrays (``tensor + ndarray``) runs on their tensors and returns
    NDArrays, as ``NDArray.__torch_function__`` does outside a trace."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from .ndarray import ndarray as nd

        kwargs = kwargs or {}
        ctx = _state.ctx
        wrapped = _has_nd(args, kwargs, nd.NDArray)
        if wrapped:
            args = nd.unwrap(args)
            kwargs = {k: nd.unwrap(v) for k, v in kwargs.items()}
        if ctx is None or not _traced_in(ctx, args, kwargs):
            out = func(*args, **kwargs)
        else:
            out = _torch_call(ctx, func, args, kwargs)
        return nd.wrap(out) if wrapped else out
