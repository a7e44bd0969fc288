"""Updater: an optimizer applied by parameter index.

Counterpart of ``mxnet_tpu/optimizer/updater.py`` (the closure the
reference's kvstore and Module-style code call): ``updater(index, grad,
weight)`` creates the index's state on first use and updates the weight in
place. ``get_states`` pickles the states as numpy arrays (with the
optimizer when asked), so the JAX package's ``set_states`` reads them and
the other way round; ``set_states`` keeps them on the host until an update
moves each to its weight's device.
"""
from __future__ import annotations

import pickle

import numpy as onp
import torch

from ..ndarray.ndarray import _to_host, unwrap
from .optimizer import Optimizer

__all__ = ["Updater", "get_updater"]


def _from_host(a):
    """A numpy state (bfloat16 as ``ml_dtypes``' too) as a CPU tensor."""
    a = onp.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(onp.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


class Updater:
    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if isinstance(index, (list, tuple)):
            for i, g, w in zip(index, grad, weight):
                self._one(i, g, w)
        else:
            self._one(index, grad, weight)

    def _one(self, index, grad, weight):
        weight, grad = unwrap(weight), unwrap(grad)
        st = self.states.get(index)
        if st is None:
            st = self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        for k, v in st.items():
            if v.device != weight.device:
                st[k] = v.to(weight.device)
        self.optimizer.update(index, weight, grad, st)

    def get_states(self, dump_optimizer=False):
        state = {k: {n: _to_host(v) for n, v in s.items()}
                 for k, s in self.states.items()}
        return pickle.dumps((state, self.optimizer)
                            if dump_optimizer else state)

    def set_states(self, states):
        """Load ``get_states``' bytes of either package. Unpickling can run
        code: load only bytes this program or the JAX package wrote."""
        data = pickle.loads(states)
        if isinstance(data, tuple):
            data, self.optimizer = data
        self.states = {k: {n: _from_host(v) for n, v in s.items()}
                       for k, s in data.items()}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
