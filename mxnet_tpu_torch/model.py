"""Checkpoint helpers (``mx.model``).

Counterpart of ``mxnet_tpu/model.py`` (reference: python/mxnet/model.py —
save_checkpoint:189, load_checkpoint:238): ``BatchEndParam``,
``save_checkpoint`` and ``load_checkpoint`` with the reference's files, so
each package loads the other's ``{prefix}-symbol.json`` and
``{prefix}-{epoch:04d}.params.npz``. A bfloat16 array is written as float32,
as ``Block.save_parameters`` writes it in both packages (the card's machine
has no numpy bfloat16 to read it back).
"""
from __future__ import annotations

import os

import numpy as onp
import torch

from .ndarray.ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]


class BatchEndParam:
    """Callback payload (reference: model.py BatchEndParam namedtuple)."""

    def __init__(self, epoch=0, nbatch=0, eval_metric=None, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _host(arr):
    t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(prefix, epoch, symbol=None, arg_params=None,
                    aux_params=None):
    """Save symbol + params at ``prefix-{epoch:04d}`` (reference: :189).

    arg_params may be a dict of NDArrays (or tensors) or a Gluon Block.
    """
    from .gluon.block import Block

    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    if isinstance(arg_params, Block):
        arg_params.save_parameters(f"{prefix}-{epoch:04d}.params.npz")
        return
    params = {}
    for name, arr in (arg_params or {}).items():
        params["arg:" + name] = _host(arr)
    for name, arr in (aux_params or {}).items():
        params["aux:" + name] = _host(arr)
    onp.savez(f"{prefix}-{epoch:04d}.params.npz", **params)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) (reference: :238); the arrays
    are NDArrays on the current context."""
    from .symbol.symbol import Symbol

    sym = None
    if os.path.exists(f"{prefix}-symbol.json"):
        sym = Symbol.load(f"{prefix}-symbol.json")
    path = f"{prefix}-{epoch:04d}.params.npz"
    arg_params, aux_params = {}, {}
    with onp.load(path) as z:
        for key in z.keys():
            if key.startswith("arg:"):
                arg_params[key[4:]] = NDArray(z[key])
            elif key.startswith("aux:"):
                aux_params[key[4:]] = NDArray(z[key])
            else:
                arg_params[key] = NDArray(z[key])
    return sym, arg_params, aux_params
