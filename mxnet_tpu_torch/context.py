"""Devices: ``cpu()``/``gpu()`` as ``torch.device`` and the placement rule.

Counterpart of ``mxnet_tpu/context.py:123-139``. The TPU backend probe of
the reference has no analog: the port targets one NVIDIA GPU.

The placement rule every entry point of the port follows: it runs on
``cuda`` unless the caller passes ``device="cpu"``. It never drops to the
CPU on its own — on a machine without a GPU, an entry point called without
a device raises :class:`MXNetError`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    """The host. ``device_id`` is accepted for API parity and ignored."""
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current GPU.

    Raises :class:`MXNetError` when ``device`` is None and no GPU is
    visible, or when a CUDA device is named on a machine without one.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "a GPU is required: no CUDA device is visible. Pass "
                "device='cpu' to run on the host explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            f"device {device!r} requested but no CUDA device is visible")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError(
            f"unsupported device {device!r}: expected cuda or cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
