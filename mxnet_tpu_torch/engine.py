"""Engine facade of the port: synchronisation at the sync points.

Counterpart of the part of ``mxnet_tpu/engine.py`` that ``npx.waitall`` and
``NDArray.wait_to_read`` use (``wait_all``, ``wait_for_var``). PyTorch
queues CUDA work on streams and returns at once, as PJRT does for the
reference; these two block the host until the queued work is done. An error
that a kernel raised on the device surfaces here as :class:`MXNetError`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["wait_all", "wait_for_var"]


def wait_for_var(data) -> None:
    """Block until the work that writes the tensor ``data`` is done: the
    current stream of its device is synchronised (reference
    ``Engine::WaitForVar``); nothing for a host tensor."""
    if data.is_cuda:
        try:
            torch.cuda.current_stream(data.device).synchronize()
        except RuntimeError as e:
            raise MXNetError(str(e)) from e


def wait_all() -> None:
    """Block until the work queued on every visible GPU is done (reference
    ``Engine::WaitForAll``); nothing on a machine without one."""
    if not torch.cuda.is_available():
        return
    try:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    except RuntimeError as e:
        raise MXNetError(str(e)) from e
