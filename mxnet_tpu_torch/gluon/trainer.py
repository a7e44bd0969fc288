"""gluon.Trainer — applies an optimizer to a set of parameters on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py:28-446``, for one device and one
worker: the eager loop ::

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sets ``rescale_grad = scale / batch_size`` (reference :196), runs
``allreduce_grads`` (nothing to reduce with one worker) and updates every
parameter whose ``grad_req`` is not ``'null'`` in place, one parameter at a
time under ``torch.no_grad()``. A parameter that no backward has reached
yet updates with a zero gradient, as the reference's zero-filled gradient
buffer does. The optimizer state is saved and loaded in the reference's
layout (a pickle of numpy arrays), so a state file of the JAX package loads
here and the other way round.

Not ported yet: the kvstore and multi-worker reduction, the fused
multi-tensor update (reference :240-390) and the compiled step
(``compile_step``).
"""
from __future__ import annotations

import pickle

import torch

from .. import optimizer as opt_mod
from ..base import MXNetError

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore=None, compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names, params = list(params), list(params.values())
        elif isinstance(params, (list, tuple)):
            names = [f"param{i}" for i in range(len(params))]
        else:
            raise MXNetError("params must be a dict or list of Parameters")
        for n, p in zip(names, params):
            if not isinstance(p, torch.nn.Parameter):
                raise MXNetError(f"invalid parameter {n}: {type(p)}")
        if kvstore not in (None, "local", "device") or update_on_kvstore:
            raise MXNetError(
                f"kvstore={kvstore!r}, update_on_kvstore="
                f"{update_on_kvstore!r}: the port's Trainer runs on one "
                "device; the kvstore is not ported yet")
        self._params = list(params)
        self._names = names
        param_dict = dict(enumerate(self._params))
        optimizer_params = optimizer_params or {}
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._states = [None] * len(self._params)
        self._scale = self._optimizer.rescale_grad

    # -- properties ---------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- the step -----------------------------------------------------------
    def allreduce_grads(self):
        """Sum gradients across workers: a no-op with the one worker the
        port has."""

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by 1/batch_size, allreduce, update.
        ``ignore_stale_grad`` is accepted for parity: the reference skips
        uninitialised parameters with it, and the port has none."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without the allreduce (manual gradient management)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    @torch.no_grad()
    def _update(self, ignore_stale_grad=False):
        opt = self._optimizer
        for i, p in enumerate(self._params):
            if getattr(p, "grad_req", "write") == "null" or \
                    not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self._states[i] is None:
                self._states[i] = opt.create_state_multi_precision(i, p)
            opt.update(i, p, p.grad, self._states[i])

    # -- checkpoint ---------------------------------------------------------
    def states_payload(self):
        """The optimizer state as host numpy arrays in the reference's
        per-parameter layout: ``{"states": [None | {key: array}],
        "num_update": int, "index_count": {index: count}}``."""
        states = [None if st is None else
                  {k: v.detach().cpu().numpy() for k, v in st.items()}
                  for st in self._states]
        return {"states": states,
                "num_update": self._optimizer.num_update,
                "index_count": dict(self._optimizer._index_update_count)}

    def load_states_payload(self, payload):
        """Restore a ``states_payload()`` snapshot of either package."""
        from ..convert import trainer_states_from_mxnet_tpu

        payload = trainer_states_from_mxnet_tpu(payload, self._params,
                                                self._names)
        self._states = payload["states"]
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload["index_count"])

    def save_states(self, fname):
        """Write the optimizer state (reference: trainer.py:434)."""
        with open(fname, "wb") as f:
            pickle.dump(self.states_payload(), f)

    def load_states(self, fname):
        """Read a state file written by ``save_states`` of either package:
        a pickle of numpy arrays, which needs no JAX to read. Unpickling
        can run code: load only files this program or the JAX package
        wrote."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        self.load_states_payload(payload)
