"""Symbol: the port's captured-graph IR.

Counterpart of ``mxnet_tpu/symbol/symbol.py``. A Symbol is a DAG of
:class:`SymNode`\\ s over registered ops, made by deferred-compute tracing
of a block's forward (:mod:`mxnet_tpu_torch._deferred_compute`) or by
composing placeholders (``sym.var`` and the op builders of
:mod:`mxnet_tpu_torch.symbol`). :class:`~mxnet_tpu_torch.cached_op.CachedOp`
runs a Symbol through its executor, one CUDA graph per input signature on
the card.

The JSON is the reference's, byte for byte in structure, so each package
loads the other's files: ``{"nodes", "heads", "mxnet_tpu_version": 1}``,
``"op": "null"`` for variables, ``"_const"`` nodes holding ``value`` as a
list and ``dtype`` as a string, literal inputs as ``{"literal": v}`` and
tuple attributes as ``{"__tuple__": [...]}``. A const node holds a tensor.
A bfloat16 constant crosses as the reference writes it: its values as a
list of floats (each exact in float32) beside ``"dtype": "bfloat16"``.
"""
from __future__ import annotations

import itertools
import json

import torch

from ..base import MXNetError, dtype_name, narrow, to_dtype
from ..ops.registry import get_op

__all__ = ["SymNode", "Symbol", "var", "Variable", "Literal", "topo_sort"]

_seq = itertools.count()


class Literal:
    """Non-tensor operand captured during tracing (a Python scalar etc.)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class SymNode:
    """One graph node: an op application, a variable, or a constant."""

    __slots__ = ("op", "attrs", "inputs", "name", "value", "seq", "nout",
                 "attr_dict")

    def __init__(self, op=None, attrs=None, inputs=(), name=None, value=None,
                 nout=1, attr_dict=None):
        self.op = op            # registry.Op, or None for var/const
        self.attrs = attrs or {}
        self.inputs = tuple(inputs)  # entries: (SymNode, out_idx) | Literal
        self.name = name
        self.value = value      # torch.Tensor for const nodes
        self.attr_dict = attr_dict or {}   # AttrScope metadata
        self.seq = next(_seq)
        self.nout = nout

    @property
    def is_var(self):
        return self.op is None and self.value is None

    @property
    def is_const(self):
        return self.op is None and self.value is not None

    def __repr__(self):
        if self.is_var:
            return f"Var({self.name})"
        if self.is_const:
            return f"Const{tuple(self.value.shape)}"
        return f"Node({self.op.name})"


def topo_sort(entries):
    """Post-order DFS over the graph reachable from output entries."""
    seen, order = set(), []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for e in node.inputs:
            if not isinstance(e, Literal):
                visit(e[0])
        order.append(node)

    for node, _ in entries:
        visit(node)
    return order


class Symbol:
    """Handle over one or more graph output entries (reference :84):
    composition through registered ops, ``list_arguments``,
    ``infer_shape``, ``tojson``/``load``, binding, indexing of
    multi-output symbols."""

    def __init__(self, entries):
        self._entries = list(entries)  # [(SymNode, out_idx)]

    # -- composition --------------------------------------------------------
    @staticmethod
    def _entry_of(x):
        if isinstance(x, Symbol):
            if len(x._entries) != 1:
                raise MXNetError(
                    "cannot use a multi-output symbol as an input")
            return x._entries[0]
        return Literal(x)

    @classmethod
    def apply_op(cls, op_name, *inputs, nout=None, **attrs):
        """One node of ``op_name`` over ``inputs`` with ``nout`` output
        entries; by default one, or the op's count for ``attrs`` where that
        follows them (``rnn``)."""
        from ..attribute import AttrScope
        from ..name import NameManager

        op = get_op(op_name)
        if nout is None:
            nout = _default_nout(op, attrs)
        entries = [cls._entry_of(x) for x in inputs]
        node = SymNode(op=op, attrs=attrs, inputs=entries, nout=nout,
                       name=NameManager.current().get(None, op_name),
                       attr_dict=AttrScope.current().get())
        return cls([(node, i) for i in range(nout)])

    def __getitem__(self, i):
        return Symbol([self._entries[i]])

    def attr(self, key):
        """An AttrScope attribute of this symbol's head node."""
        return self._entries[0][0].attr_dict.get(key)

    def list_attr(self):
        return dict(self._entries[0][0].attr_dict)

    def __len__(self):
        return len(self._entries)

    @property
    def name(self):
        node, _ = self._entries[0]
        return node.name or f"node{node.seq}"

    def __add__(self, o):
        return Symbol.apply_op("add", self, o)

    def __sub__(self, o):
        return Symbol.apply_op("subtract", self, o)

    def __mul__(self, o):
        return Symbol.apply_op("multiply", self, o)

    def __truediv__(self, o):
        return Symbol.apply_op("true_divide", self, o)

    def __pow__(self, o):
        return Symbol.apply_op("power", self, o)

    def __neg__(self):
        return Symbol.apply_op("negative", self)

    # -- binding (reference :149-186) ----------------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             **kwargs):
        from ..executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req)

    _bind = bind

    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        """Bind to float32 zeros of the given shapes on ``ctx``'s device,
        with zero gradient buffers unless ``grad_req`` is ``'null'``."""
        from ..context import resolve_device
        from ..executor import Executor
        from ..ndarray.ndarray import NDArray

        device = resolve_device(ctx)
        args, grads = {}, {}
        for name in self.list_arguments():
            if name not in shapes:
                raise MXNetError(f"simple_bind: missing shape for {name!r}")
            shape = tuple(shapes[name])
            args[name] = NDArray(torch.zeros(shape, device=device))
            grads[name] = NDArray(torch.zeros(shape, device=device))
        return Executor(self, ctx, args,
                        grads if grad_req != "null" else None, grad_req)

    def eval(self, ctx=None, **kwargs):
        """One-shot evaluation with named inputs."""
        return self.bind(ctx, args=kwargs).forward()

    def optimize_for(self, backend, *args, **kwargs):
        """Run a registered subgraph-pass backend over this symbol."""
        from .. import subgraph

        return subgraph.apply_passes(self, backend)

    # -- introspection ------------------------------------------------------
    def list_arguments(self):
        return [n.name for n in topo_sort(self._entries) if n.is_var]

    def list_outputs(self):
        return [f"{n.name or 'node%d' % n.seq}_output{i}"
                for n, i in self._entries]

    def get_internals(self):
        nodes = topo_sort(self._entries)
        return Symbol([(n, 0) for n in nodes])

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, [])`` for ``name=shape`` of every
        variable (float32), as the reference's (:207-232, there through
        ``jax.eval_shape``): the executor runs on tensors of the ``meta``
        device, or, where an op's function cannot take them, on zeros on
        the CPU."""
        from ..cached_op import build_executor

        var_nodes = [n for n in topo_sort(self._entries) if n.is_var]
        shapes = []
        for n in var_nodes:
            if n.name not in kwargs:
                raise MXNetError(f"infer_shape: missing shape for '{n.name}'")
            shapes.append(tuple(int(s) for s in kwargs[n.name]))
        fn, _ = build_executor(self._entries, var_nodes)
        with torch.no_grad():
            try:
                out = fn(*[torch.empty(s, device="meta") for s in shapes])
            except Exception:  # noqa: BLE001 — an op without meta support
                out = fn(*[torch.zeros(s) for s in shapes])
        return shapes, [tuple(o.shape) for o in out], []

    # -- serialization ------------------------------------------------------
    def tojson(self):
        """The graph as the reference's JSON (reference :236)."""
        nodes = topo_sort(self._entries)
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            if n.is_var:
                jnodes.append({"op": "null", "name": n.name or f"var{n.seq}",
                               "inputs": []})
            elif n.is_const:
                value = narrow(n.value)     # the reference's 32-bit types
                jnodes.append({"op": "_const",
                               "name": f"const{n.seq}",
                               "value": _const_list(value),
                               "dtype": dtype_name(value.dtype),
                               "inputs": []})
            else:
                ins = []
                for e in n.inputs:
                    if isinstance(e, Literal):
                        ins.append({"literal": e.value})
                    else:
                        ins.append([idx[id(e[0])], e[1]])
                jnodes.append({"op": n.op.name, "name": n.name or f"n{n.seq}",
                               "attrs": _json_attrs(n.attrs), "inputs": ins})
        heads = [[idx[id(n)], i] for n, i in self._entries]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=1)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    @staticmethod
    def fromjson(s: str) -> "Symbol":
        """A Symbol from either package's JSON; an op the port has not
        registered raises :class:`MXNetError` naming it."""
        g = json.loads(s)
        nodes = []
        for jn in g["nodes"]:
            if jn["op"] == "null":
                nodes.append(SymNode(name=jn["name"]))
            elif jn["op"] == "_const":
                nodes.append(SymNode(value=_const_tensor(jn)))
            else:
                ins = []
                for e in jn["inputs"]:
                    if isinstance(e, dict):
                        ins.append(Literal(e["literal"]))
                    else:
                        ins.append((nodes[e[0]], e[1]))
                attrs = _unjson_attrs(jn.get("attrs", {}))
                op = get_op(_legacy(jn["op"]))
                nodes.append(SymNode(op=op, attrs=attrs, inputs=ins,
                                     name=jn.get("name"),
                                     nout=_default_nout(op, attrs)))
        return Symbol([(nodes[i], j) for i, j in g["heads"]])

    @staticmethod
    def load(fname) -> "Symbol":
        with open(fname) as f:
            return Symbol.fromjson(f.read())


def _default_nout(op, attrs):
    """A node's output count when nothing names it: ``op.sym_nout(attrs)``
    where the op sets that hook, else one (the reference's)."""
    return 1 if op.sym_nout is None else op.sym_nout(attrs)


def _legacy(op_name):
    """The registered name of a JSON node's op: a name of
    ``_LEGACY_NAMES`` (``SoftmaxOutput``, ``Concat``, ...) mapped as
    ``mx.nd`` maps it; the alias table's names (``Correlation``, ``RNN``,
    ...) are names of the registry already."""
    from . import _LEGACY_NAMES

    return _LEGACY_NAMES.get(op_name, op_name)


def _const_list(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().tolist()     # exact: bf16 is a prefix of fp32
    return t.numpy().tolist()


def _const_tensor(jn):
    if jn["dtype"] == "bfloat16":
        return torch.tensor(jn["value"], dtype=torch.float32).to(
            torch.bfloat16)
    return torch.tensor(jn["value"], dtype=to_dtype(jn["dtype"]))


def _json_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, tuple):
            v = {"__tuple__": [x for x in v]}
        out[k] = v
    return out


def _unjson_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__tuple__" in v:
            v = tuple(v["__tuple__"])
        if isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


def var(name=None, shape=None, dtype=None, **kw):
    """A free variable symbol (reference :314). AttrScope attributes in
    effect (and explicit ``**kw``) attach to the node; ``shape`` is kept as
    the ``__shape__`` attribute that shape-sensitive passes read."""
    from ..attribute import AttrScope
    from ..name import NameManager

    name = NameManager.current().get(name, "var")
    attrs = AttrScope.current().get({k: str(v) for k, v in kw.items()})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    return Symbol([(SymNode(name=name, attr_dict=attrs), 0)])


Variable = var
