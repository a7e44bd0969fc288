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

``cast(dtype)`` changes the parameter's dtype in place (reference :211): the
same object, so trainers and blocks that hold it see the new data, with a
zero gradient of the new dtype attached.

Deferred shapes (reference :28, :89-130): a parameter whose shape holds a 0
(a layer built without ``in_units``/``in_channels``) is a placeholder, an
empty tensor, until the first forward gives its shape. ``initialize()``
only records its initializer (with the generator and the name);
:meth:`Parameter._finish_deferred_init` then fills it **in place**, the
same object (``p.data = ...``), so a ``Trainer`` built before the first
forward holds it; a placeholder never initialised gets zeros. Filling one
inside a CUDA graph capture raises: the capture would record an allocation
and a host-side draw that no replay repeats.
"""
from __future__ import annotations

import weakref

import torch

from ..base import MXNetError, to_dtype

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
        # (initializer, generator, name) recorded by initialize() while the
        # shape is unknown
        self._deferred_init = None
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

    @property
    def is_deferred(self):
        """True while the shape holds a 0: a placeholder awaiting its first
        forward (or a loaded file)."""
        return not all(self.shape)

    def _check_fill(self, shape):
        """Raise unless the placeholder may become ``shape`` now: the same
        rank, every known extent kept, and no CUDA graph capturing."""
        if len(shape) != self.dim() or any(
                old and old != new for old, new in zip(self.shape, shape)):
            raise MXNetError(f"cannot change the shape of a parameter from "
                             f"{tuple(self.shape)} to {tuple(shape)}")
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                f"parameter of shape {tuple(self.shape)} is filled during a "
                "CUDA graph capture: run one forward before capturing")

    @torch.no_grad()
    def _fill(self, data):
        """Become ``data`` (a tensor of this parameter's final shape), in
        place: the same object, its gradient dropped."""
        self._check_fill(tuple(data.shape))
        self.data = data.to(device=self.device, dtype=self.dtype)
        self.grad = None
        self._deferred_init = None

    @torch.no_grad()
    def _finish_deferred_init(self, shape):
        """Give the placeholder its ``shape`` and fill it from the
        initializer ``initialize()`` recorded (zeros when none was), by the
        reference's fill by name."""
        shape = tuple(int(n) for n in shape)
        self._check_fill(shape)
        host = torch.zeros(shape, dtype=torch.float32)
        if self._deferred_init is not None:
            init, gen, name = self._deferred_init
            init.init_array(name, host, gen)
        self._fill(host)

    @torch.no_grad()
    def cast(self, dtype):
        """Change the dtype of the data to ``dtype`` (a torch dtype or its
        name) in place; a parameter that takes gradients gets a zero
        gradient of the new dtype (reference :211). The data moves to new
        memory, so a compiled train step that captured the old address
        captures anew at its next call."""
        self.data = self.data.to(to_dtype(dtype))
        self.grad = None if self._grad_req == "null" else \
            torch.zeros_like(self.data)


def _overwrite(p):
    """After torch accumulated into ``p.grad``: under ``'write'``, put the
    fresh gradient in place of the sum."""
    fresh, p._fresh_grad = p._fresh_grad, None
    if fresh is not None and p.grad is not fresh:
        p.grad.copy_(fresh)
