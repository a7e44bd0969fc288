"""Symbol package: the graph IR and the symbolic composition API.

Counterpart of ``mxnet_tpu/symbol/__init__.py``. Every registered op is a
symbolic builder (``sym.exp(x)``, ``sym.matmul(a, b)``, the CamelCase
legacy names such as ``sym.FullyConnected`` or ``sym.RNN``), resolved
lazily by module ``__getattr__``: through ``_LEGACY_NAMES`` (the
reference's 13), else the registry, which holds the reference's alias
table (``ops/aliases.py``). A builder makes one output entry, or the op's
count where that follows its attributes (``sym.RNN``: three for LSTM, else
two); ``nout=`` overrides it.
"""
from .symbol import Literal, Symbol, SymNode, Variable, topo_sort, var

__all__ = ["Symbol", "SymNode", "Literal", "var", "Variable", "topo_sort",
           "Group", "load", "fromjson"]

_LEGACY_NAMES = {
    "FullyConnected": "fully_connected",
    "Convolution": "convolution",
    "Deconvolution": "deconvolution",
    "Pooling": "pooling",
    "BatchNorm": "batch_norm",
    "LayerNorm": "layer_norm",
    "Activation": "activation",
    "LeakyReLU": "leaky_relu",
    "Dropout": "dropout",
    "Embedding": "embedding",
    "SoftmaxOutput": "softmax",
    "Concat": "concatenate",
    "Flatten": "flatten",
}


def Group(symbols):
    """One multi-output symbol of ``symbols``' outputs, in order."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname):
    return Symbol.load(fname)


def fromjson(json_str):
    return Symbol.fromjson(json_str)


def _make_sym_op(op_name):
    def sym_op(*inputs, **attrs):
        name = attrs.pop("name", None)
        nout = attrs.pop("nout", None)
        out = Symbol.apply_op(op_name, *inputs, nout=nout, **attrs)
        if name is not None:
            out._entries[0][0].name = name
        return out

    sym_op.__name__ = op_name
    return sym_op


def __getattr__(name):
    from ..ops.registry import _OPS

    op_name = _LEGACY_NAMES.get(name, name)
    if op_name in _OPS:
        fn = _make_sym_op(op_name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no attribute "
                         f"{name!r}")
