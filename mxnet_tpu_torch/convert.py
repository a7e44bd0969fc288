"""Carry parameters and optimizer state from the JAX package into the port.

The JAX package saves a block's parameters as a numpy ``savez`` archive
keyed by ``collect_params()`` names (``mxnet_tpu/gluon/block.py:117``); the
port names its parameters the same way, so arrays cross by name. Its
``Trainer`` saves the optimizer state as a pickle of numpy arrays, one
entry per parameter in ``collect_params()`` order
(``mxnet_tpu/gluon/trainer.py:400-446``); the port's ``Trainer`` keeps the
same layout, so states cross by position.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["params_from_mxnet_tpu", "trainer_states_from_mxnet_tpu"]


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


def trainer_states_from_mxnet_tpu(payload, params, names=None):
    """Turn a ``Trainer.states_payload()`` of the JAX package (or of the
    port) into the port's: each state array becomes a float32 tensor on its
    parameter's device. ``params`` are the trainer's parameters in order;
    ``names`` name them in errors. Raises :class:`MXNetError` when the
    number of entries or a state's shape does not match."""
    names = names or [f"param{i}" for i in range(len(params))]
    states = payload["states"]
    if len(states) != len(params):
        raise MXNetError(
            f"optimizer state holds {len(states)} entries for "
            f"{len(params)} parameters")
    out = []
    for name, p, st in zip(names, params, states):
        if st is None:
            out.append(None)
            continue
        conv = {}
        for key, arr in st.items():
            t = torch.from_numpy(onp.array(arr, dtype="float32", copy=True))
            if tuple(t.shape) != tuple(p.shape):
                raise MXNetError(
                    f"parameter {name}: state {key!r} of shape "
                    f"{tuple(t.shape)}, parameter of shape {tuple(p.shape)}")
            conv[key] = t.to(p.device)
        out.append(conv)
    return {"states": out, "num_update": int(payload["num_update"]),
            "index_count": {int(i): int(c) for i, c in
                            payload["index_count"].items()}}
