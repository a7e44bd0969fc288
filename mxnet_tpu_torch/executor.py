"""Executor: bind a Symbol to argument arrays and run it.

Counterpart of ``mxnet_tpu/executor.py``, the legacy GraphExecutor facade
that MXNet 2.0 reimplemented over CachedOp, and so is it here: ``bind``
makes a :class:`~mxnet_tpu_torch.cached_op.CachedOp` of the Symbol (one
CUDA graph per input signature on the card), and ``forward`` /
``backward`` run through the imperative machinery, so autograd works:
``forward(is_train=True)`` records one tape node, ``backward`` writes the
gradients into the ``args_grad`` arrays by ``grad_req``.
"""
from __future__ import annotations

from . import autograd
from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]


class Executor:
    def __init__(self, sym, ctx=None, args=None, args_grad=None,
                 grad_req="write"):
        from .cached_op import CachedOp
        from .context import resolve_device
        from .symbol.symbol import topo_sort

        self._sym = sym
        var_nodes = [n for n in topo_sort(sym._entries) if n.is_var]
        names = [n.name for n in var_nodes]
        if isinstance(args, dict):
            missing = [n for n in names if n not in args]
            if missing:
                raise MXNetError(f"bind: missing arguments {missing}")
            args = [args[n] for n in names]
        elif isinstance(args, (list, tuple)):
            if len(args) != len(names):
                raise MXNetError(f"bind: expected {len(names)} args "
                                 f"({names}), got {len(args)}")
        else:
            raise MXNetError("bind requires args as dict or list")
        device = resolve_device(ctx) if ctx is not None else None
        self._args = [a if isinstance(a, NDArray) else NDArray(a)
                      for a in args]
        if device is not None:
            self._args = [a if a._data.device == device else
                          NDArray(a._data.to(device)) for a in self._args]
        self._arg_names = names
        self._cop = CachedOp(sym, var_nodes, name="executor")
        self._grad_req = grad_req
        self._args_grad = args_grad
        if args_grad:
            if isinstance(args_grad, dict):
                grads = [args_grad.get(n) for n in names]
            else:
                if len(args_grad) != len(names):
                    raise MXNetError(
                        f"bind: args_grad has {len(args_grad)} entries but "
                        f"the symbol has {len(names)} arguments ({names})")
                grads = list(args_grad)
            for arr, g in zip(self._args, grads):
                if g is not None:
                    autograd.mark_variables([arr], [g], [grad_req])
        self.outputs = []

    def forward(self, is_train=False, **kwargs):
        for name, value in kwargs.items():
            if name not in self._arg_names:
                raise MXNetError(f"unknown argument {name!r}")
            self._args[self._arg_names.index(name)]._set_data(
                value._data if isinstance(value, NDArray) else value)
        if is_train:
            with autograd.record():
                out = self._cop(*self._args)
        else:
            out = self._cop(*self._args)
        self.outputs = list(out) if isinstance(out, tuple) else [out]
        return self.outputs

    def backward(self, out_grads=None):
        if not self.outputs:
            raise MXNetError("call forward(is_train=True) before backward")
        grads = out_grads if isinstance(out_grads, (list, tuple)) else \
            ([out_grads] if out_grads is not None else None)
        autograd.backward(self.outputs, grads)

    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self._args))
