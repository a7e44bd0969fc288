"""Seeded random generators of the port: one ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/random.py:38-55``. The reference keeps one
process-global key, seeded by ``seed(n)`` and split on every draw. The port
keeps one ``torch.Generator`` per device, each seeded with the same ``n``
when it is made and again by every ``seed(n)``; dropout draws from the
generator of its tensor's device (:func:`generator`). The two packages draw
different numbers from one seed, so a test that needs the same noise in
both makes it with numpy.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_seed = 0
_gens = {}


def seed(seed_state: int):
    """Re-seed every device's generator (reference: ``mx.random.seed``)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _gens.values():
            gen.manual_seed(_seed)


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device`` or its name), made
    on first use from the current seed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = _gens[dev] = torch.Generator(device=dev)
            gen.manual_seed(_seed)
    return gen
