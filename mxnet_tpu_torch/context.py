"""Devices: ``cpu()``/``gpu()`` as ``torch.device`` and the placement rule.

Counterpart of ``mxnet_tpu/context.py:123-139``, plus the kernel tuning
cache's location (:func:`tuning_cache_path`, reference :629) and the
environment signature it is keyed by (reference ``_probe_env_signature``,
:253). The TPU backend probe of the reference has no analog: the port
targets one NVIDIA GPU.

The placement rule every entry point of the port follows: it runs on
``cuda`` unless the caller passes ``device="cpu"``. It never drops to the
CPU on its own — on a machine without a GPU, an entry point called without
a device raises :class:`MXNetError`.
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
import tempfile
from pathlib import Path

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device", "env_signature",
           "tuning_cache_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"


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


@functools.lru_cache(maxsize=None)
def env_signature() -> str:
    """Hash of everything a tuned kernel winner depends on: the interpreter,
    ``torch.__version__`` and ``torch.version.cuda``, the card's name (or
    ``cpu`` where none is visible) and a digest of the kernel sources in
    ``mxnet_tpu_torch/csrc/``. Winners tuned under one signature are never
    replayed under another: a new card, toolkit or tile code re-tunes."""
    h = hashlib.sha256()
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode() + b"\0" + src.read_bytes())
    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    parts = [sys.executable, torch.__version__, str(torch.version.cuda),
             card, h.hexdigest()]
    return hashlib.sha256("\0".join(parts).encode()).hexdigest()[:16]


def tuning_cache_path() -> str | None:
    """On-disk kernel tuning cache (``tune/``) for this environment, or
    None when persistence is disabled.

    Default: ``<TMPDIR>/mxtpu_torch_tune_<uid>/<env signature>/
    tuning_cache.json``, one directory per :func:`env_signature`.
    ``MXTPU_TUNE_CACHE`` overrides the full path (the tune layer still
    refuses a file whose recorded signature differs);
    ``MXTPU_TUNE_CACHE=off`` disables persistence while leaving the
    in-process tier working."""
    override = os.environ.get("MXTPU_TUNE_CACHE", "")
    if override.lower() in ("0", "off", "none", "disabled"):
        return None
    if override:
        return override
    return os.path.join(tempfile.gettempdir(),
                        f"mxtpu_torch_tune_{os.getuid()}", env_signature(),
                        "tuning_cache.json")
