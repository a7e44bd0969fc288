"""Devices: :class:`Context`, ``cpu()``/``gpu()`` and the placement rule.

Counterpart of ``mxnet_tpu/context.py``: :class:`Context` (:42-122, a
``(device_type, device_id)`` value that is also a ``with`` scope), ``cpu``,
``gpu``, ``device``, ``current_context`` (:123-160, :548-585), ``num_gpus``
and ``gpu_memory_info``; plus the kernel tuning cache's location
(:func:`tuning_cache_path`, reference :629) and the environment signature it
is keyed by (reference ``_probe_env_signature``, :253); and the data
workers' pin to the host (:func:`spawn_cpu_pinned_env`,
:func:`pin_process_to_cpu`, reference :481-520). The TPU backend probe of
the reference has no analog: the port targets one NVIDIA GPU.

The placement rule every entry point of the port follows: it runs on
``cuda`` unless the caller asks for the CPU, by ``device="cpu"`` (or
``ctx=mx.cpu()``) or inside ``with mx.cpu():``. It never drops to the CPU
on its own: on a machine without a GPU, an entry point called without a
device outside such a scope raises :class:`MXNetError`.
"""
from __future__ import annotations

import contextlib
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
           "resolve_device", "env_signature", "tuning_cache_path",
           "spawn_cpu_pinned_env", "pin_process_to_cpu"]

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


# os.environ is process-wide: one spawn at a time changes it
_spawn_lock = threading.Lock()


@contextlib.contextmanager
def spawn_cpu_pinned_env():
    """``CUDA_VISIBLE_DEVICES=""`` around ``Process.start()``, so a spawned
    child sees no GPU from its first instruction: it can create no CUDA
    context and build no kernel, even while it re-imports the parent's
    ``__main__`` (reference :481, which pins the children's JAX to the
    CPU). Workers are spawned, never forked: CUDA cannot be initialised
    again in a forked child.

    The variable is read by the CUDA runtime once, when a process first
    asks for its devices; ``torch.cuda.is_available()`` here makes this
    process do so first, with its own value, before the value changes. A
    thread of this process that has not touched CUDA before and calls
    ``torch.cuda.device_count()`` inside the window would still read the
    empty value (torch counts through NVML until CUDA is initialised), so
    the window is only the ``start()`` calls, under one lock."""
    torch.cuda.is_available()
    with _spawn_lock:
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            yield
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved


def pin_process_to_cpu() -> None:
    """Worker side (reference :506): hide every GPU from this process and
    make the host this thread's device, so arrays a dataset or batchify
    function makes land on the CPU and nothing initialises CUDA. Spawned
    workers call it first thing."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    Context._local.stack = [cpu()]
