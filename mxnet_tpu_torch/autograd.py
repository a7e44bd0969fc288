"""Imperative autograd of the port, over ``torch.autograd``.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``/``pause``/
``train_mode``/``predict_mode`` at :53-100, ``backward``/``grad`` at
:334-400). The reference keeps its own tape of per-op VJPs; here torch's
autograd is the tape. ``record()`` switches torch's grad mode on and
``pause()`` off, so ops inside ``pause()`` are not recorded, as in the
reference. Outside both, torch's own default holds (grad mode on): tensors
that require grad are recorded there too, where the reference records
nothing.

The training flag is thread-local, as the reference's. It is what dropout
reads (:func:`mxnet_tpu_torch.ops.nn.dropout`): ``record()`` sets it, so
dropout is active inside ``record()`` and the identity outside it.

The parameters' ``grad_req`` (``'write'``, ``'add'``, ``'null'``) is kept by
:class:`mxnet_tpu_torch.gluon.parameter.Parameter`.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad"]


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


def _heads(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    return list(heads), list(head_grads)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the ``.grad`` of every parameter they
    reach, by each parameter's ``grad_req`` (reference :334). A head
    without a head gradient is seeded with ones, as in the reference, so a
    per-sample loss vector backpropagates its sum; torch's own
    ``Tensor.backward()`` takes only a scalar."""
    heads, head_grads = _heads(heads, head_grads)
    head_grads = [torch.ones_like(h) if g is None else g
                  for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, head_grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned and not
    stored (reference :363); a variable the heads do not reach gets
    zeros. ``create_graph`` records them for higher-order gradients."""
    single = not isinstance(variables, (list, tuple))
    var_list = [variables] if single else list(variables)
    heads, head_grads = _heads(heads, head_grads)
    outs = torch.autograd.grad(heads, var_list, head_grads,
                               retain_graph=retain_graph,
                               create_graph=create_graph, allow_unused=True)
    outs = [torch.zeros_like(v) if o is None else o
            for o, v in zip(outs, var_list)]
    return outs[0] if single else outs
