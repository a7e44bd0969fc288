"""Devices: :class:`Context`, ``cpu()``/``gpu()`` and the placement rule.

Counterpart of ``mxnet_tpu/context.py``: :class:`Context` (:42-122, a
``(device_type, device_id)`` value that is also a ``with`` scope), ``cpu``,
``gpu``, ``device``, ``current_context`` (:123-160, :548-585), ``num_gpus``
and ``gpu_memory_info``; plus the kernel tuning cache's location
(:func:`tuning_cache_path`, reference :629) and the environment signature it
is keyed by (reference ``_probe_env_signature``, :253). The TPU backend
probe of the reference has no analog: the port targets one NVIDIA GPU.

The placement rule every entry point of the port follows: it runs on
``cuda`` unless the caller asks for the CPU, by ``device="cpu"`` (or
``ctx=mx.cpu()``) or inside ``with mx.cpu():``. It never drops to the CPU
on its own: on a machine without a GPU, an entry point called without a
device outside such a scope raises :class:`MXNetError`.
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
import tempfile
import threading
from pathlib import Path

import torch

from .base import MXNetError

__all__ = ["Context", "Device", "cpu", "gpu", "device", "current_context",
           "current_device", "num_gpus", "gpu_memory_info",
           "resolve_device", "env_signature", "tuning_cache_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_DEVTYPES = ("cpu", "gpu", "cpu_pinned", "cpu_shared")


class Context:
    """Execution device handle (reference :42): ``Context("gpu", 0)``,
    usable as the ``ctx``/``device`` argument everywhere and as a scope
    (``with mx.cpu(): ...``) that sets :func:`current_context` on this
    thread. :attr:`torch_device` is the ``torch.device`` it names."""

    _local = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in _DEVTYPES:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``: ``cuda:<id>`` for a GPU (raises where
        none is visible), else ``cpu``."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} requested but no CUDA device is visible")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(Context._local, "stack", None)
        if stack is None:
            stack = Context._local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._local.stack.pop()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__


Device = Context  # mxnet 2.x renamed Context -> Device; keep both names


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def context_of(dev: torch.device) -> Context:
    """The :class:`Context` of a ``torch.device``."""
    if dev.type == "cuda":
        return Context("gpu", torch.cuda.current_device()
                       if dev.index is None else dev.index)
    return Context("cpu", 0)


def device(dev=None, device_id: int = 0) -> Context:
    """A :class:`Context` from a Context, a ``torch.device``, a name
    (``"gpu"``, ``"cpu:0"``, ``"cuda:1"``) or None (the current one)."""
    if dev is None:
        return current_context()
    if isinstance(dev, Context):
        return dev
    if isinstance(dev, torch.device):
        return context_of(dev)
    if isinstance(dev, str):
        kind, _, idx = dev.partition(":")
        kind = "gpu" if kind == "cuda" else kind
        return Context(kind, int(idx) if idx else device_id)
    raise MXNetError(f"cannot interpret {dev!r} as a device")


def current_context() -> Context:
    """The innermost ``with`` scope's Context on this thread, else the
    current GPU. Raises :class:`MXNetError` with neither (reference :548,
    whose default is the accelerator too)."""
    stack = getattr(Context._local, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError(
            "a GPU is required: no CUDA device is visible. Pass "
            "device='cpu' (or ctx=mx.cpu()), or work inside "
            "`with mx.cpu():`, to run on the host explicitly")
    return Context("gpu", torch.cuda.current_device())


current_device = current_context


def num_gpus() -> int:
    return torch.cuda.device_count()


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of a GPU's memory (reference :580, over
    ``cudaMemGetInfo``)."""
    dev = gpu(device_id).torch_device
    return torch.cuda.mem_get_info(dev)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: a :class:`Context`, a
    ``torch.device`` or its name; None means :func:`current_context`.

    Raises :class:`MXNetError` when ``device`` is None and neither a GPU
    nor a ``with`` scope gives a device, or when a CUDA device is named on a
    machine without one.
    """
    if device is None:
        return current_context().torch_device
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device("cuda" if device == "gpu" else device)
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
