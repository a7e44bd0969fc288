"""gluon.Parameter — a ``torch.nn.Parameter`` with the reference's knobs.

Counterpart of ``mxnet_tpu/gluon/parameter.py:30-85``: ``lr_mult`` and
``wd_mult`` (read by the optimizer through the ``Trainer``), the parameter's
own initializer, and ``grad_req``:

- ``'write'`` (the default): each backward that reaches the parameter
  overwrites its ``.grad``, as the reference does. Torch adds into
  ``.grad``; a hook on the parameter keeps the gradient a backward brings
  and, once torch has accumulated it, writes it over the sum.
- ``'add'``: torch's own accumulation — gradients of successive backward
  calls add up until the caller zeroes them (:meth:`Parameter.zero_grad`).
- ``'null'``: no gradient (``requires_grad`` False, ``.grad`` dropped); the
  ``Trainer`` skips the parameter.

A backward that does not reach a parameter leaves its ``.grad`` as it was,
in every mode, as in the reference.
"""
from __future__ import annotations

import weakref

import torch

from ..base import MXNetError

__all__ = ["Parameter"]

_GRAD_REQS = ("write", "add", "null")


class Parameter(torch.nn.Parameter):
    """``Parameter(data, grad_req="write", lr_mult=1.0, wd_mult=1.0,
    init=None)``. Ops on it return plain tensors, as on any
    ``torch.nn.Parameter``."""

    def __new__(cls, data=None, requires_grad=True, grad_req="write",
                lr_mult=1.0, wd_mult=1.0, init=None):
        if grad_req not in _GRAD_REQS:
            raise MXNetError(
                f"grad_req must be one of {_GRAD_REQS}, got {grad_req!r}")
        return super().__new__(cls, data,
                               requires_grad and grad_req != "null")

    def __init__(self, data=None, requires_grad=True, grad_req="write",
                 lr_mult=1.0, wd_mult=1.0, init=None):
        self._grad_req = grad_req if requires_grad else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.mx_init = init
        self._fresh_grad = None
        self._hooked = False
        if self.requires_grad:
            self._hook()

    def _hook(self):
        """The two hooks of ``'write'`` (torch takes hooks only on a tensor
        that requires grad, so a ``'null'`` parameter gets them when it
        first leaves ``'null'``)."""
        if self._hooked:
            return
        ref = weakref.ref(self)

        def keep(g):   # before torch accumulates: the gradient it brings
            p = ref()
            if p is not None and p._grad_req == "write":
                p._fresh_grad = g

        self.register_hook(keep)
        self.register_post_accumulate_grad_hook(_overwrite)
        self._hooked = True

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError(
                f"grad_req must be one of {_GRAD_REQS}, got {req!r}")
        self._grad_req = req
        self.requires_grad_(req != "null")
        if req == "null":
            self.grad = None
        else:
            self._hook()

    def zero_grad(self):
        if self.grad is not None:
            self.grad.zero_()


def _overwrite(p):
    """After torch accumulated into ``p.grad``: under ``'write'``, put the
    fresh gradient in place of the sum."""
    fresh, p._fresh_grad = p._fresh_grad, None
    if fresh is not None and p.grad is not fresh:
        p.grad.copy_(fresh)
