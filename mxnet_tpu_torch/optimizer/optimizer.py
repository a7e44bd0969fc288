"""Optimizers of the port: each one a plain per-tensor recurrence.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer`` base
(:42-297) and the reference's nineteen registered optimizers: ``SGD``
(:349), ``NAG`` (:392), ``Adam`` and ``AdamW`` (:410-479), ``Adamax``
(:482), ``Nadam`` (:502), ``RMSProp`` (:524), ``AdaGrad`` (:557),
``AdaDelta`` (:583), ``Ftrl`` (:603), ``FTML`` (:640), ``Signum`` (:663),
``LAMB`` (:691), ``LARS`` (:728), ``LANS`` (:754), ``AdaBelief`` (:792),
``SGLD`` (:813), ``DCASGD`` (:829) and ``GroupAdaGrad`` (:858). Each
optimizer declares its recurrence once (``_register_step``, reference
:199-222) as a plain function on tensors, ``step(w, *states, g, lr, wd[,
t])``, returning the new weight and states. One declaration serves both
paths: ``update`` runs it on one parameter under ``torch.no_grad()`` and
writes the results into the weight and state tensors in place, where the
reference rebinds donated buffers; the ``Trainer``'s fused multi-tensor
update and the compiled train step read it through
:attr:`Optimizer.fused_step`. ``elementwise=True`` lets the fused path run
the recurrence once over many small tensors flattened into one vector,
with the hypers spread per element; LAMB, LARS, LANS, GroupAdaGrad and NAG
are not elementwise (whole-tensor norms, row sums), so each of their
tensors runs alone. ``SGLD`` draws noise in its ``_apply`` and declares no
step, so it has no fused path (the compiled step falls back to the eager
loop for it, as the reference's does).

Inside a captured step the hypers are device tensors, so no recurrence
reads a value to the host: guards are ``torch.where`` on device scalars,
never a Python branch on a norm.

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
float64 ``t``) on the fused paths; a bias correction ``1 - beta ** t`` is
computed in double either way and rounded to float32 where it divides.

A row-sparse gradient (a ``RowSparseNDArray``, reference :164-185) takes
the optimizer's lazy path where it has one (``_apply_sparse``: SGD
without momentum, Adam with ``lazy_update`` and bias correction, AdaGrad,
Ftrl, GroupAdaGrad; :mod:`mxnet_tpu_torch.ops.optimizer_ops`): only the
gradient's rows of the weight and of its states move, with
``rescale_grad`` and the clip applied by the update itself. Under
``multi_precision`` the float32 master is updated and its touched rows
are rounded into the weight. The others (``lazy_update=False``, SGD with
momentum, AdamW, the rest) densify the gradient and take the dense step,
as the reference does.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _oo

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "Adamax", "Nadam",
           "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "FTML", "Signum",
           "LAMB", "LARS", "LANS", "AdaBelief", "SGLD", "DCASGD",
           "GroupAdaGrad", "create", "register"]

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

    update_multi_precision = update

    def _update_one(self, index, weight, grad, state):
        from ..ndarray.sparse import RowSparseNDArray

        t = self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        if isinstance(grad, RowSparseNDArray):
            target = state.get("weight_fp32", weight)
            if self._apply_sparse(target, grad, state, lr, wd, t):
                if target is not weight:   # round the touched rows down
                    idx = grad.indices._data.long()
                    weight.index_copy_(0, idx, target.index_select(
                        0, idx).to(weight.dtype))
                return
            grad = grad.todense()._data
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
            # the states first: a state may take the old weight (DCASGD)
            for k, new in zip(keys, out[1:]):
                state[k].copy_(new)
            weight.copy_(out[0])
        else:
            weight.copy_(out)

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        """Lazy row-sparse update of ``weight`` (and ``state``) in place;
        True when handled. The base has none: the caller densifies."""
        return False

    def _sparse_args(self, grad):
        """(rows, indices, rescale_grad, clip) for the sparse cores; a
        clip of -1 is off."""
        return (grad.data._data, grad.indices._data, self.rescale_grad,
                -1.0 if self.clip_gradient is None else self.clip_gradient)

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

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

        def step(w, mom, g, lr, wd):
            g = self._pre(g).float()
            wf = w.float()
            w_new, mom = _oo.sgd_mom_step(wf, mom, g + wd * wf, lr,
                                          self.momentum)
            return w_new.to(w.dtype), mom

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

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        if self.momentum != 0.0 or not self.lazy_update:
            return False   # dense momentum, or dense semantics asked for
        rows, idx, rescale, clip = self._sparse_args(grad)
        _oo.sparse_sgd_(weight, rows, idx, lr, wd, rescale, clip)
        return True


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: nag_mom_update)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum

        def step(w, mom, g, lr, wd):
            return _oo.nag_mom_step(w, mom, self._pre(g) + wd * w, lr,
                                    self.momentum)

        self._register_step(step, ("mom",))

    def create_state(self, index, weight):
        return {"mom": torch.zeros(weight.shape, dtype=torch.float32,
                                   device=weight.device)}


def _zeros(weight, *keys):
    """float32 zero states of ``weight``'s shape, one a key."""
    return {k: torch.zeros(weight.shape, dtype=torch.float32,
                           device=weight.device) for k in keys}


def _bias_correction(beta, t):
    """``1 - beta ** t`` in double; float32 where ``t`` is a tensor (the
    fused paths), so it divides a float32 moment as the Python double of
    the per-parameter path does: rounded to float32 first."""
    if isinstance(t, torch.Tensor):
        return (1 - beta ** t.double()).float()
    return 1 - beta ** t


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, adamw=False,
                 lazy_update=True, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias
        self.lazy_update = lazy_update
        b1, b2, eps = beta1, beta2, epsilon
        decoupled = self._decoupled_wd = adamw

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
        return _zeros(weight, "mean", "var")

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        """Lazy Adam (reference :446): the moments and the weight move on
        the active rows only, bias-corrected by the shared step count.
        AdamW's decoupled decay touches every row: dense."""
        if self._decoupled_wd or not self.lazy_update or \
                not self.correct_bias:
            return False
        rows, idx, rescale, clip = self._sparse_args(grad)
        _oo.sparse_adam_(weight, state["mean"], state["var"], rows, idx, lr,
                         wd, self.beta1, self.beta2, self.epsilon, rescale,
                         clip, _oo._bc(self.beta1, t),
                         _oo._bc(self.beta2, t))
        return True


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


@register
class Adamax(Optimizer):
    """Adam with the infinity norm (reference :482)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate, **kwargs)
        b1, b2 = beta1, beta2

        def step(w, m, u, g, lr, wd, t):
            g = self._pre(g) + wd * w
            m = b1 * m + (1 - b1) * g
            u = torch.maximum(b2 * u, g.abs())
            return w - lr / _bias_correction(b1, t) * m / (u + 1e-8), m, u

        self._register_step(step, ("mean", "u"), needs_t=True,
                            elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "mean", "u")


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (reference :502)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate, **kwargs)
        b1, b2, eps = beta1, beta2, epsilon

        def step(w, m, v, g, lr, wd, t):
            g = self._pre(g) + wd * w
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / _bias_correction(b1, t + 1)
            vhat = v / _bias_correction(b2, t)
            upd = b1 * mhat + (1 - b1) * g / _bias_correction(b1, t)
            return w - lr * upd / (torch.sqrt(vhat) + eps), m, v

        self._register_step(step, ("mean", "var"), needs_t=True,
                            elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "mean", "var")


@register
class RMSProp(Optimizer):
    """RMSProp, plain or ``centered`` (reference :524)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.centered = centered
        self.momentum = momentum

        def step(w, n, g_avg, mom, g, lr, wd):
            g = self._pre(g) + wd * w
            n = rho * n + (1 - rho) * g * g
            if centered:
                g_avg = rho * g_avg + (1 - rho) * g
                denom = torch.sqrt(n - g_avg * g_avg + epsilon)
            else:
                denom = torch.sqrt(n + epsilon)
            if momentum > 0:
                mom = momentum * mom - lr * g / denom
                w = w + mom
            else:
                w = w - lr * g / denom
            return w, n, g_avg, mom

        self._register_step(step, ("n", "g", "mom"), elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "n", "g", "mom")


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference :557)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._eps = epsilon

        def step(w, h, g, lr, wd):
            g = self._pre(g) + wd * w
            h = h + g * g
            return w - lr * g / (torch.sqrt(h) + epsilon), h

        self._register_step(step, ("history",), elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "history")

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        rows, idx, rescale, clip = self._sparse_args(grad)
        _oo.sparse_adagrad_(weight, state["history"], rows, idx, lr, wd,
                            self._eps, rescale, clip)
        return True


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference :583)."""

    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate, **kwargs)

        def step(w, acc_g, acc_d, g, lr, wd):
            g = self._pre(g) + wd * w
            acc_g = rho * acc_g + (1 - rho) * g * g
            delta = torch.sqrt(acc_d + epsilon) / \
                torch.sqrt(acc_g + epsilon) * g
            acc_d = rho * acc_d + (1 - rho) * delta * delta
            return w - lr * delta, acc_g, acc_d

        self._register_step(step, ("acc_g", "acc_delta"), elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "acc_g", "acc_delta")


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (reference :603)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._lamda1, self._beta = lamda1, beta

        def step(w, z, n, g, lr, wd):
            return _oo.ftrl_step(w, z, n, self._pre(g), lr, lamda1, beta, wd)

        self._register_step(step, ("z", "n"), elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "z", "n")

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        rows, idx, rescale, clip = self._sparse_args(grad)
        _oo.sparse_ftrl_(weight, state["z"], state["n"], rows, idx, lr,
                         self._lamda1, self._beta, wd, rescale, clip)
        return True


@register
class FTML(Optimizer):
    """Follow the moving leader (reference :640)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        b1, b2, eps = beta1, beta2, epsilon

        def step(w, d, s, z, g, lr, wd, t):
            return _oo.ftml_step(w, d, s, z, self._pre(g) + wd * w, lr, b1,
                                 b2, eps, _bias_correction(b1, t),
                                 _bias_correction(b2, t))

        self._register_step(step, ("d", "s", "z"), needs_t=True,
                            elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "d", "s", "z")


@register
class Signum(Optimizer):
    """signSGD with momentum (reference :663); ``wd_lh`` is accepted, as
    in the reference, which does not read it."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum

        def step(w, mom, g, lr, wd):
            return _oo.signum_step(w, mom, self._pre(g) + wd * w, lr,
                                   self.momentum)

        def step_nomom(w, g, lr, wd):
            g = self._pre(g) + wd * w
            return w - lr * torch.sign(g)

        if momentum == 0.0:
            self._register_step(step_nomom, elementwise=True)
        else:
            self._register_step(step, ("mom",), elementwise=True)

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return {}
        return _zeros(weight, "mom")


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (reference :691): Adam's direction plus
    decoupled decay, scaled by the trust ratio ``|w| / |r|`` of the whole
    tensor (1 where either norm is 0); ``lower_bound``/``upper_bound``
    clamp ``|w|``. Not elementwise."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction
        b1, b2, eps = beta1, beta2, epsilon

        def step(w, m, v, g, lr, wd, t):
            g = self._pre(g).float()
            wf = w.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            if bias_correction:
                mhat = m / _bias_correction(b1, t)
                vhat = v / _bias_correction(b2, t)
            else:
                mhat, vhat = m, v
            r = mhat / (torch.sqrt(vhat) + eps) + wd * wf
            w_norm = _oo.norm(wf)
            if lower_bound is not None:
                w_norm = w_norm.clamp(min=lower_bound)
            if upper_bound is not None:
                w_norm = w_norm.clamp(max=upper_bound)
            ratio = _oo.trust_ratio(w_norm, _oo.norm(r))
            return (wf - lr * ratio * r).to(w.dtype), m, v

        self._register_step(step, ("mean", "var"), needs_t=True)

    def create_state(self, index, weight):
        return _zeros(weight, "mean", "var")


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference :728): momentum SGD
    whose step is scaled by ``eta |w| / (|g| + wd |w| + eps)`` of the whole
    tensor (1 where either norm is 0). Not elementwise."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum

        def step(w, mom, g, lr, wd):
            g = self._pre(g)
            w_norm = _oo.norm(w)
            g_norm = _oo.norm(g)
            trust = torch.where(
                (w_norm > 0) & (g_norm > 0),
                eta * w_norm / (g_norm + wd * w_norm + epsilon),
                torch.ones_like(w_norm))
            g = g + wd * w
            mom = self.momentum * mom + trust * lr * g
            return w - mom, mom

        self._register_step(step, ("mom",))

    def create_state(self, index, weight):
        return _zeros(weight, "mom")


@register
class LANS(Optimizer):
    """LAMB on the normalised gradient, with two trust ratios (reference
    :754): the moment's and the gradient's directions, each scaled by its
    own ``|w| / |r|``, mixed by ``beta1``. Not elementwise."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        b1, b2, eps = beta1, beta2, epsilon

        def step(w, m, v, g, lr, wd, t):
            g = self._pre(g).float()
            g = g / _oo.norm(g).clamp(min=1e-12)
            wf = w.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / _bias_correction(b1, t)
            vhat = v / _bias_correction(b2, t)
            w_norm = _oo.norm(wf)

            def trust(update):
                r = update + wd * wf
                return _oo.trust_ratio(w_norm, _oo.norm(r)) * r

            r1 = trust(mhat / (torch.sqrt(vhat) + eps))
            r2 = trust(g / (torch.sqrt(vhat) + eps))
            upd = b1 * r1 + (1 - b1) * r2
            return (wf - lr * upd).to(w.dtype), m, v

        self._register_step(step, ("mean", "var"), needs_t=True)

    def create_state(self, index, weight):
        return _zeros(weight, "mean", "var")


@register
class AdaBelief(Optimizer):
    """AdaBelief (reference :792): Adam with the variance of the gradient
    around its moment."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        b1, b2, eps = beta1, beta2, epsilon

        def step(w, m, v, g, lr, wd, t):
            g = self._pre(g) + wd * w
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * (g - m) ** 2 + eps
            mhat = m / _bias_correction(b1, t)
            vhat = v / _bias_correction(b2, t)
            return w - lr * mhat / (torch.sqrt(vhat) + eps), m, v

        self._register_step(step, ("mean", "var"), needs_t=True,
                            elementwise=True)

    def create_state(self, index, weight):
        return _zeros(weight, "mean", "var")


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference :813): a half step
    down the gradient plus N(0, lr) noise, drawn from the generator of
    :mod:`mxnet_tpu_torch.random` on the weight's device. It declares no
    fused step (its ``_apply`` draws), so the ``Trainer`` updates it per
    parameter and the compiled step takes the eager loop."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)

    def _apply(self, w, g, state, lr, wd, t):
        from .. import random as _random

        noise = torch.randn(w.shape, generator=_random.generator(w.device),
                            device=w.device) * math.sqrt(lr)
        gd = self._pre(g) + wd * w
        w.copy_(w - lr / 2 * gd + noise.to(w.dtype))


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (reference :829): the gradient corrected by
    ``lamda g² (w - w_prev)``, the previous weight kept as a state."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

        def step(w, prev_w, mom, g, lr, wd):
            g = self._pre(g) + wd * w
            g = g + self.lamda * g * g * (w - prev_w)
            mom = self.momentum * mom - lr * g
            return w + mom, w, mom

        self._register_step(step, ("prev", "mom"), elementwise=True)

    def create_state(self, index, weight):
        return {"prev": weight.detach().clone(),
                **_zeros(weight, "mom")}


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one history value a row (reference :858): the mean of
    the squared gradient over the non-row axes accumulates per row. Weight
    decay is rejected, as in the reference. Not elementwise (its state is
    (rows, 1, ...))."""

    @staticmethod
    def _reject_wd(wd):
        if wd:
            raise ValueError("GroupAdaGrad does not support weight decay "
                             "(the reference's restriction)")

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        self._reject_wd(kwargs.get("wd"))
        super().__init__(learning_rate, **kwargs)
        self._eps = epsilon

        def step(w, h, g, lr, wd):
            g = self._pre(g)
            if g.dim() > 1:
                h = h + (g * g).mean(dim=tuple(range(1, g.dim())),
                                     keepdim=True)
            else:
                h = h + g * g
            return w - lr * g / (torch.sqrt(h) + epsilon), h

        self._register_step(step, ("history",))

    def create_state(self, index, weight):
        shape = (weight.shape[0],) + (1,) * (weight.dim() - 1) \
            if weight.dim() else ()
        return {"history": torch.zeros(shape, dtype=torch.float32,
                                       device=weight.device)}

    def _apply(self, w, g, state, lr, wd, t):
        self._reject_wd(float(wd))
        super()._apply(w, g, state, lr, wd, t)

    def _apply_sparse(self, weight, grad, state, lr, wd, t):
        """Only the touched rows update (reference :895): rescale, then
        clip, no weight decay."""
        self._reject_wd(float(wd))
        rows, idx, rescale, clip = self._sparse_args(grad)
        _oo.sparse_group_adagrad_(weight, state["history"], rows, idx, lr,
                                  self._eps, rescale, clip)
        return True
