"""Carry parameters from the JAX package into the port.

The JAX package saves a block's parameters as a numpy ``savez`` archive
keyed by ``collect_params()`` names (``mxnet_tpu/gluon/block.py:117``); the
port names its parameters the same way, so arrays cross by name.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["params_from_mxnet_tpu"]


def params_from_mxnet_tpu(arrays, model=None):
    """Turn the JAX package's parameters, as ``{name: numpy array}``, into
    the port's ``{name: torch.Tensor}``.

    Every value must be a numeric array. With ``model`` (a port block), the
    names must be exactly ``model.collect_params()``'s and every shape must
    match; the tensors then take each parameter's dtype and device.
    Raises :class:`MXNetError` naming the first mismatch.
    """
    out = {}
    for name, arr in arrays.items():
        a = onp.asarray(arr)
        if a.dtype.kind not in "fiu":
            raise MXNetError(
                f"parameter {name}: unsupported dtype {a.dtype}")
        out[name] = torch.from_numpy(onp.array(a, copy=True))
    if model is None:
        return out
    params = model.collect_params()
    missing = sorted(set(params) - set(out))
    extra = sorted(set(out) - set(params))
    if missing or extra:
        raise MXNetError(
            f"parameter names differ: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        if tuple(out[name].shape) != tuple(p.shape):
            raise MXNetError(
                f"parameter {name}: shape {tuple(out[name].shape)} from the "
                f"JAX package, {tuple(p.shape)} in the port")
        out[name] = out[name].to(device=p.device, dtype=p.dtype)
    return out
