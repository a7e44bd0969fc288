"""Automatic mixed precision (AMP) of the port.

Counterpart of ``mxnet_tpu/amp/__init__.py``, with the reference's
cast-at-the-op design, not ``torch.autocast``'s: while AMP is on, each op
named in ``MXU_FUNCS`` (matrix products: ``fully_connected``, ``matmul``,
``multihead_attention``, ``flash_attention``, ...) casts its float32
tensor arguments to the target dtype at its entry. The cast lives in the
op registry, as the reference's: ``invoke`` (and the tensor-level doors of
``ops.nn``, which read this same state) add the ``__amp__`` attribute and
``Op.fn`` wraps the op's function with the casts
(:func:`mxnet_tpu_torch.ops.registry._amp_wrap`; reference
``ops/registry.py:215-217``, :283-297).
Every other op follows the dtype that flows in, so under
``init("bfloat16")`` the logits of a tied LM head come out bf16, a
``log_softmax`` of them stays bf16 (``torch.autocast`` would upcast it),
and a residual ``x (fp32) + proj (bf16)`` promotes back to fp32. The casts
are differentiable: the gradients of fp32 parameters come back fp32.

The state (on or off, the dtype) is thread-local, as the reference's
(:33). bf16 needs no loss scaling; ``scale_loss``/``unscale`` and the loss
scalers serve float16 (:106-130). ``convert_hybrid_block`` casts a block's
parameters to the low-precision dtype and keeps the norm parameters in
fp32 (:132). Dtype names map to torch dtypes through
:func:`mxnet_tpu_torch.base.to_dtype`; the fp8 names to
``torch.float8_e4m3fn`` / ``torch.float8_e5m2``. The CUDA kernels of the
port take float32 and bfloat16 only, so float16 and fp8 under AMP run on
the CPU's plain versions and raise in the kernels' wrappers on the card.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..base import to_dtype
from .lists import AMP_DTYPES, FP32_FUNCS, MXU_FUNCS
from .loss_scaler import DynamicLossScaler, LossScaler, StaticLossScaler

__all__ = ["init", "disable", "is_enabled", "target_dtype", "resolve_dtype",
           "autocast", "attach_loss_scaler", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "LossScaler",
           "StaticLossScaler", "DynamicLossScaler", "MXU_FUNCS",
           "FP32_FUNCS", "AMP_DTYPES", "MXU_OPS", "FP32_OPS"]

MXU_OPS = frozenset(MXU_FUNCS)
FP32_OPS = frozenset(FP32_FUNCS)

_state = threading.local()


def _st():
    if not hasattr(_state, "enabled"):
        _state.enabled = False
        _state.dtype = "bfloat16"
    return _state


def resolve_dtype(name):
    """Normalise and validate an AMP dtype name (``float8_e4m3`` is taken
    for ``float8_e4m3fn``); raises ValueError outside ``AMP_DTYPES``."""
    dt = str(name)
    if dt == "float8_e4m3":
        dt = "float8_e4m3fn"
    if dt not in AMP_DTYPES:
        raise ValueError(
            f"amp target_dtype must be one of {AMP_DTYPES}, got {name!r}")
    return dt


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for this thread (reference :52). The op-list arguments
    are accepted for the reference's signature and not used."""
    dt = resolve_dtype(target_dtype)   # validate before any state changes
    st = _st()
    st.enabled = True
    st.dtype = dt
    return True


def disable():
    _st().enabled = False


def is_enabled() -> bool:
    return _st().enabled


def target_dtype() -> str:
    return _st().dtype


def _snapshot():
    """(enabled, dtype name) of this thread's AMP state."""
    st = _st()
    return st.enabled, st.dtype


@contextlib.contextmanager
def _scoped(state):
    """Run a block under the AMP state ``state`` (a ``_snapshot()``), the
    previous state restored after it."""
    st = _st()
    prev = (st.enabled, st.dtype)
    st.enabled, st.dtype = state
    try:
        yield
    finally:
        st.enabled, st.dtype = prev


class autocast:
    """``with amp.autocast("bfloat16"):`` — AMP on inside the block, the
    previous state (on or off, its dtype) restored on exit."""

    def __init__(self, dtype="bfloat16"):
        self.dtype = resolve_dtype(dtype)

    def __enter__(self):
        st = _st()
        self._prev = (st.enabled, st.dtype)
        st.enabled, st.dtype = True, self.dtype
        return self

    def __exit__(self, *exc):
        _st().enabled, _st().dtype = self._prev


def attach_loss_scaler(optimizer_or_trainer, scaler=None):
    """Attach (or create) the loss scaler that ``scale_loss`` and
    ``Trainer.compile_step`` consult; returns it. An explicit ``scaler``
    replaces any attached one."""
    if scaler is None:
        scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
        if scaler is None:
            scaler = DynamicLossScaler()
    optimizer_or_trainer._amp_loss_scaler = scaler
    return scaler


@contextlib.contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """``with amp.scale_loss(loss, trainer) as scaled:`` — yields ``loss``
    itself when the AMP dtype is bfloat16, else ``loss`` times the
    attached scaler's ``loss_scale`` (a scaler is attached when none is;
    reference :106)."""
    if _st().dtype == "bfloat16":
        yield loss
    else:
        scaler = attach_loss_scaler(optimizer_or_trainer)
        yield loss * scaler.loss_scale


@torch.no_grad()
def unscale(optimizer_or_trainer):
    """Divide the gradient of every trainable parameter of the trainer
    (``_params``, each ``param.grad``) by the attached scaler's
    ``loss_scale``, in place; nothing without a scaler (reference :121)."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    for param in optimizer_or_trainer._params:
        if getattr(param, "grad_req", "write") == "null" or \
                param.grad is None:
            continue
        param.grad.div_(scaler.loss_scale)


_KEEP_FP32 = ("gamma", "beta", "running_mean", "running_var", "moving_mean",
              "moving_var")


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None):
    """Cast ``block``'s parameters to ``target_dtype`` in place, keeping the
    norm layers' parameters (names ending in ``gamma``, ``beta``,
    ``running_mean``, ``running_var``, ``moving_mean``, ``moving_var``) in
    fp32 (reference :132); returns the block."""
    dt = to_dtype(target_dtype)
    for name, param in block.collect_params().items():
        if any(name.endswith(s) for s in _KEEP_FP32):
            continue
        param.cast(dt)
    return block


def convert_model(*args, **kwargs):
    raise NotImplementedError("symbolic convert_model: use "
                              "convert_hybrid_block on the Gluon API")
