"""Imperative autograd of the port, over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``/``pause``/
``train_mode``/``predict_mode`` at :53-100, ``mark_variables``,
``backward`` and ``grad`` at :179-400). The reference keeps its own tape of
per-op VJPs; here torch's autograd is the tape. ``record()`` switches
torch's grad mode on and ``pause()`` off.

On NDArrays the reference's semantics hold: an op records only inside
``record()`` (``ops.registry.invoke`` runs it with grad mode set to
``is_recording()``), so ``backward()`` on a result computed outside it
raises :class:`MXNetError`; ``attach_grad`` / :func:`mark_variables` make
an array a gradient sink with a ``grad_req`` (``'write'`` overwrites,
``'add'`` accumulates, ``'null'`` stores nothing; see
:mod:`mxnet_tpu_torch.ndarray.ndarray`); :func:`grad` with
``create_graph`` records the gradients for higher orders. On plain tensors
(the tensor-level path of GPT, the losses and the trainer) torch's own
rule holds: outside both scopes grad mode is on.

A second-order gradient through a hand-written kernel follows what the
kernel's backward can do: LayerNorm's backward is the plain formula's vjp,
differentiable again; the flash-attention kernels' backward is a kernel
pair that autograd cannot differentiate, so a gradient through it with
``create_graph`` raises :class:`MXNetError` (on the CPU the plain version
runs and is differentiable).

The training flag is thread-local, as the reference's. It is what dropout
reads (:func:`mxnet_tpu_torch.ops.nn.dropout`): ``record()`` sets it, so
dropout is active inside ``record()`` and the identity outside it.

The parameters' ``grad_req`` is kept by
:class:`mxnet_tpu_torch.gluon.parameter.Parameter`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]

_GRAD_REQS = ("write", "add", "null")


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(flag: bool) -> bool:
    prev, _state.recording = _state.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _state.training = _state.training, bool(flag)
    return prev


@contextlib.contextmanager
def _scope(recording=None, training=None):
    prev_r = set_recording(recording) if recording is not None else None
    prev_t = set_training(training) if training is not None else None
    grad_mode = (torch.set_grad_enabled(recording) if recording is not None
                 else contextlib.nullcontext())
    try:
        with grad_mode:
            yield
    finally:
        if recording is not None:
            set_recording(prev_r)
        if training is not None:
            set_training(prev_t)


def record(train_mode: bool = True):
    """``with autograd.record():`` — record ops for a later backward;
    training mode (dropout active) unless ``train_mode=False``."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode: bool = False):
    """Stop recording (torch grad mode off) inside a ``record()`` block."""
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def _nd():
    from .ndarray.ndarray import NDArray

    return NDArray


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make the NDArrays ``variables`` gradient sinks whose gradients go
    into the NDArrays ``gradients`` by ``grad_reqs`` (reference :212,
    ``Imperative::MarkVariables``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise MXNetError(
                f"grad_req must be one of {_GRAD_REQS}, got {req!r}")
        var._grad = g
        var._grad_req = req
        var._data = var._data.detach().requires_grad_(True)
        if req != "null":
            var._data.grad = g._data
        var._hook()


def _unwrap(x):
    return x._data if isinstance(x, _nd()) else x


def _heads(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    NDArray = _nd()
    tensors = []
    for h in heads:
        if isinstance(h, NDArray):
            if not h._data.requires_grad:
                raise MXNetError(
                    "cannot differentiate: output is not connected to any "
                    "recorded computation (did you call backward outside "
                    "autograd.record(), or forget attach_grad?)")
            h = h._data
        tensors.append(h)
    grads = [torch.ones_like(h) if g is None else
             torch.as_tensor(_unwrap(g), dtype=h.dtype, device=h.device)
             for h, g in zip(tensors, head_grads)]
    return tensors, grads


def _torch_errors(fn, *args, **kwargs):
    """``fn`` with torch's autograd errors raised as :class:`MXNetError`
    (reference: a freed graph, a kernel without a second derivative)."""
    try:
        return fn(*args, **kwargs)
    except MXNetError:
        raise
    except RuntimeError as e:
        raise MXNetError(str(e)) from e


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays or tensors) into every variable and
    parameter they reach, by each one's ``grad_req`` (reference :334). A
    head without a head gradient is seeded with ones, as in the reference,
    so a per-sample loss vector backpropagates its sum; torch's own
    ``Tensor.backward()`` takes only a scalar."""
    heads, head_grads = _heads(heads, head_grads)
    _torch_errors(torch.autograd.backward, heads, head_grads,
                  retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned and not
    stored (reference :363); a variable the heads do not reach gets
    zeros. NDArray variables must be marked (``attach_grad``) and give
    NDArrays. ``create_graph`` records the gradients for higher-order
    gradients, as inside ``record()``."""
    single = not isinstance(variables, (list, tuple))
    var_list = [variables] if single else list(variables)
    NDArray = _nd()
    nd = [isinstance(v, NDArray) for v in var_list]
    for v, is_nd in zip(var_list, nd):
        if is_nd and v._grad is None:
            raise MXNetError("autograd.grad: variables must have attached "
                             "grads or be marked via mark_variables")
    leaves = [_unwrap(v) for v in var_list]
    heads, head_grads = _heads(heads, head_grads)
    scope = _scope(recording=True, training=train_mode) if create_graph \
        else contextlib.nullcontext()
    with scope:
        outs = _torch_errors(torch.autograd.grad, heads, leaves, head_grads,
                             retain_graph=retain_graph,
                             create_graph=create_graph, allow_unused=True)
    outs = [torch.zeros_like(v) if o is None else o
            for o, v in zip(outs, leaves)]
    outs = [NDArray(o) if is_nd else o for o, is_nd in zip(outs, nd)]
    return outs[0] if single else outs
