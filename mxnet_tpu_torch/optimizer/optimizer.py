"""Optimizers of the port: each one a plain per-tensor recurrence.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:42-297) and ``SGD`` (:349-380), ``NAG`` (:392-407), ``Adam`` and ``AdamW``
(:410-479). Each optimizer declares its recurrence once
(``_register_step``, reference :202-222) as a plain function on tensors,
``step(w, *states, g, lr, wd[, t])``, returning the new weight and states;
``update`` runs it under ``torch.no_grad()`` and writes the results into
the weight and state tensors in place, where the reference rebinds donated
buffers. The reference's other optimizers, its lazy row-sparse updates and
the fused multi-tensor path are not ported yet.

Semantics kept from the reference: ``rescale_grad`` multiplies the gradient
outside the step (:183-188) and ``clip_gradient`` then clips it, where a
value <= 0 turns clipping off (:288-294); ``lr_mult``/``wd_mult`` come from
the parameter and from ``set_lr_mult``/``set_wd_mult``; the update count
``t`` is kept per parameter index (:100-105); momentum and moment states
are float32 whatever the weight's dtype; with ``multi_precision`` a
bfloat16/float16 weight is updated through a float32 master copy
(:145-151, :189-194).
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "create", "register"]

_registry = {}


def register(cls):
    """Make ``cls`` creatable by its lower-case name."""
    _registry[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _registry[str(name).lower()]
    except KeyError:
        raise MXNetError(
            f"optimizer {name!r} is not registered (ported: "
            f"{sorted(_registry)})") from None
    return cls(**kwargs)


class Optimizer:
    """Base optimizer: learning-rate and weight-decay plumbing, update
    counts, state creation and the in-place update."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, multi_precision=False,
                 param_dict=None, **kwargs):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict or {}
        self.lr_mult, self.wd_mult = {}, {}
        self._step_spec = None

    # -- hyperparameter plumbing -------------------------------------------
    def set_learning_rate(self, lr):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr * self.lr_mult.get(index, 1.0)

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd * self.wd_mult.get(index, 1.0)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])
        return self._index_update_count[index]

    # -- state --------------------------------------------------------------
    def create_state(self, index, weight) -> dict:
        return {}

    def create_state_multi_precision(self, index, weight):
        state = self.create_state(index, weight)
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            state["weight_fp32"] = weight.detach().float().clone()
        return state

    # -- the update ---------------------------------------------------------
    @torch.no_grad()
    def update(self, index, weight, grad, state):
        """Update ``weight`` (and ``state``) in place from ``grad``. Lists
        of each are accepted, as in the reference."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self._update_one(i, w, g, s)
        else:
            self._update_one(index, weight, grad, state)

    def _update_one(self, index, weight, grad, state):
        t = self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if self.rescale_grad != 1.0:
            grad = grad * self.rescale_grad
        if "weight_fp32" in state:
            master = state["weight_fp32"]
            self._apply(master, grad, state, lr, wd, t)
            weight.copy_(master.to(weight.dtype))
        else:
            self._apply(weight, grad, state, lr, wd, t)

    def _register_step(self, step, state_keys=(), needs_t=False):
        """Declare the recurrence ``step(w, *states, g, lr, wd[, t])`` ->
        new weight, or (new weight, *new states) in ``state_keys`` order."""
        self._step_spec = (step, tuple(state_keys), needs_t)

    def _apply(self, weight, grad, state, lr, wd, t):
        if self._step_spec is None:
            raise NotImplementedError(
                f"{type(self).__name__} declares no per-tensor step")
        step, keys, needs_t = self._step_spec
        args = [weight, *(state[k] for k in keys), grad, lr, wd]
        if needs_t:
            args.append(t)
        out = step(*args)
        if keys:
            weight.copy_(out[0])
            for k, new in zip(keys, out[1:]):
                state[k].copy_(new)
        else:
            weight.copy_(out)

    def _pre(self, g):
        """Clip the (rescaled) gradient; clip_gradient <= 0 is off."""
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


@register
class SGD(Optimizer):
    """SGD with optional momentum (reference: sgd_mom_update); the step
    runs in float32."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum

        def step(w, mom, g, lr, wd):
            g = self._pre(g).float()
            wf = w.float()
            g = g + wd * wf
            mom = self.momentum * mom - lr * g
            return (wf + mom).to(w.dtype), mom

        def step_nomom(w, g, lr, wd):
            g = self._pre(g).float()
            wf = w.float()
            return (wf - lr * (g + wd * wf)).to(w.dtype)

        if momentum == 0.0:
            self._register_step(step_nomom)
        else:
            self._register_step(step, ("mom",))

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return {}
        return {"mom": torch.zeros(weight.shape, dtype=torch.float32,
                                   device=weight.device)}


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: nag_mom_update)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum

        def step(w, mom, g, lr, wd):
            g = self._pre(g) + wd * w
            mom = self.momentum * mom + g
            return w - lr * (g + self.momentum * mom), mom

        self._register_step(step, ("mom",))

    def create_state(self, index, weight):
        return {"mom": torch.zeros(weight.shape, dtype=torch.float32,
                                   device=weight.device)}


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, adamw=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias
        b1, b2, eps = beta1, beta2, epsilon
        decoupled = adamw

        def step(w, m, v, g, lr, wd, t):
            g = self._pre(g).float()
            wf = w.float()
            if not decoupled:   # Adam: L2 on the gradient
                g = g + wd * wf
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            if self.correct_bias:
                mhat = m / (1 - b1 ** t)
                vhat = v / (1 - b2 ** t)
            else:
                mhat, vhat = m, v
            upd = mhat / (torch.sqrt(vhat) + eps)
            if decoupled:       # AdamW: decay beside the update
                upd = upd + wd * wf
            return (wf - lr * upd).to(w.dtype), m, v

        self._register_step(step, ("mean", "var"), needs_t=True)

    def create_state(self, index, weight):
        z = dict(dtype=torch.float32, device=weight.device)
        return {"mean": torch.zeros(weight.shape, **z),
                "var": torch.zeros(weight.shape, **z)}


@register
class Adam(_AdamBase):
    """Adam (reference: adam_update): weight decay added to the gradient."""

    def __init__(self, learning_rate=0.001, **kwargs):
        super().__init__(learning_rate, adamw=False, **kwargs)


@register
class AdamW(_AdamBase):
    """Adam with decoupled weight decay (reference: contrib adamw)."""

    def __init__(self, learning_rate=0.001, **kwargs):
        super().__init__(learning_rate, adamw=True, **kwargs)
