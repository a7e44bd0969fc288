"""Optimizers of the port: each one a plain per-tensor recurrence.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:42-297) and ``SGD`` (:349-380), ``NAG`` (:392-407), ``Adam`` and ``AdamW``
(:410-479). Each optimizer declares its recurrence once
(``_register_step``, reference :199-222) as a plain function on tensors,
``step(w, *states, g, lr, wd[, t])``, returning the new weight and states.
One declaration serves both paths: ``update`` runs it on one parameter
under ``torch.no_grad()`` and writes the results into the weight and state
tensors in place, where the reference rebinds donated buffers; the
``Trainer``'s fused multi-tensor update and the compiled train step read it
through :attr:`Optimizer.fused_step`. ``elementwise=True`` (SGD, Adam,
AdamW; not NAG, as the reference declares it) lets the fused path run the
recurrence once over many small tensors flattened into one vector, with
the hypers spread per element. The reference's other optimizers and its
lazy row-sparse updates are not ported yet.

Semantics kept from the reference: ``rescale_grad`` multiplies the gradient
outside the step (:183-188) and ``clip_gradient`` then clips it, where a
value <= 0 turns clipping off (:288-294); ``lr_mult``/``wd_mult`` come from
the parameter and from ``set_lr_mult``/``set_wd_mult``; the update count
``t`` is kept per parameter index (:100-105), and the compiled step stages
counts and commits them only for a step that was not skipped
(``_staged_counts``, ``_commit_counts``, :107-147); momentum and moment
states are float32 whatever the weight's dtype; with ``multi_precision`` a
bfloat16/float16 weight is updated through a float32 master copy
(:145-151, :189-194). The hypers ``lr``, ``wd`` and ``t`` arrive as Python
numbers on the per-parameter path and as tensors (float32 ``lr``/``wd``,
float64 ``t``) on the fused paths; Adam's bias correction ``1 - beta ** t``
is computed in double either way and rounded to float32 where it divides.
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
        self._fusable = None

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

    def _get_lr(self, index, num_update=None):
        nu = self.num_update if num_update is None else num_update
        lr = self.lr_scheduler(nu) if self.lr_scheduler else self.lr
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

    def _staged_counts(self, indices):
        """Tentative per-index update counts and ``num_update`` of the step
        about to run, without mutating (reference :107): a compiled step
        the loss scaler later skips must leave the schedule where it was.
        Returns ``(counts, num_update)``."""
        counts = [self._index_update_count.get(i, 0) + 1 for i in indices]
        return counts, max([self.num_update] + counts)

    def _staged_counts_k(self, indices, k):
        """``_staged_counts`` for ``k`` steps in one call (reference :119):
        row ``j`` is what the ``j``-th committed step would see. The step
        indexes the rows by its committed-step counter, so a skipped inner
        step reads its row again. Returns ``(rows, num_updates)``."""
        base = {i: self._index_update_count.get(i, 0) for i in indices}
        nu = self.num_update
        rows, nus = [], []
        for j in range(k):
            counts = [base[i] + j + 1 for i in indices]
            rows.append(counts)
            nus.append(max([nu] + counts))
            nu = max(nu, max(counts))
        return rows, nus

    def _commit_counts(self, indices):
        """Apply the counts staged by ``_staged_counts``."""
        for i in indices:
            self._update_count(i)

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

    def _register_step(self, step, state_keys=(), needs_t=False,
                       fusable=True, elementwise=False):
        """Declare the recurrence ``step(w, *states, g, lr, wd[, t])`` ->
        new weight, or (new weight, *new states) in ``state_keys`` order.
        ``fusable=False`` keeps the per-parameter step but opts out of the
        fused paths; ``elementwise=True`` asserts the step is purely
        per-element, so the fused path may flatten small tensors into one
        call (reference :199-222)."""
        self._step_spec = (step, tuple(state_keys), needs_t, elementwise)
        self._fusable = self._step_spec if fusable else None

    @property
    def fused_step(self):
        """``(step, state_keys, needs_t, elementwise)`` for the fused
        multi-tensor update and the compiled step, or None when this
        optimizer cannot be fused."""
        return self._fusable

    def _apply(self, weight, grad, state, lr, wd, t):
        if self._step_spec is None:
            raise NotImplementedError(
                f"{type(self).__name__} declares no per-tensor step")
        step, keys, needs_t, _ = self._step_spec
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
            self._register_step(step_nomom, elementwise=True)
        else:
            self._register_step(step, ("mom",), elementwise=True)

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


def _bias_correction(beta, t):
    """``1 - beta ** t`` in double; float32 where ``t`` is a tensor (the
    fused paths), so it divides a float32 moment as the Python double of
    the per-parameter path does: rounded to float32 first."""
    if isinstance(t, torch.Tensor):
        return (1 - beta ** t.double()).float()
    return 1 - beta ** t


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
                mhat = m / _bias_correction(b1, t)
                vhat = v / _bias_correction(b2, t)
            else:
                mhat, vhat = m, v
            upd = mhat / (torch.sqrt(vhat) + eps)
            if decoupled:       # AdamW: decay beside the update
                upd = upd + wd * wf
            return (wf - lr * upd).to(w.dtype), m, v

        self._register_step(step, ("mean", "var"), needs_t=True,
                            elementwise=True)

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
