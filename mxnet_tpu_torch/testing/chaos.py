"""Fault-injection harness (`MXTPU_FAULT_*`): deterministic failures at
named points in production code paths.

Counterpart of ``mxnet_tpu/testing/chaos.py``, which is pure Python: the
port keeps its own copy (same points, spec grammar and calls) and never
imports the JAX package. Firings count in the port's telemetry registry.

The robustness subsystems (crash-consistent checkpointing, serving
self-healing) are only trustworthy if their failure paths are *driven* in
tests, not reasoned about. Production code declares an injection point
with one call::

    from ..testing import chaos
    chaos.fault_point("ckpt.write.manifest")

and a test (or operator reproducing an incident) arms it either through
the environment —

    MXTPU_FAULT_CKPT_WRITE_MANIFEST=die          # SIGKILL self at the point
    MXTPU_FAULT_DECODE_TICK=raise                # raise FaultError, every hit
    MXTPU_FAULT_DECODE_TICK=raise:2              # skip 2 hits, then raise
    MXTPU_FAULT_DECODE_TICK=raise:0:3            # raise on the first 3 hits
    MXTPU_FAULT_CKPT_MANIFEST_CORRUPT=corrupt    # site applies corruption

— or programmatically with :func:`inject` (same spec, no subprocess
needed). Spec grammar: ``action[:countdown[:times]]`` where ``action`` is
``die`` (SIGKILL the process — indistinguishable from ``kill -9`` mid-
write), ``raise`` (raise :class:`FaultError`), ``corrupt`` (the point
returns True and the call site applies the corruption it knows how to
perform), or ``flag`` (returns True — corruption-free observation, e.g.
the simulated preemption signal); ``countdown`` hits pass through before
the fault fires
(default 0) and the fault fires ``times`` times before disarming
(default: forever). Transient-failure tests use ``raise:0:2``-style
specs so a retry layer can be seen to recover.

Cost when nothing is armed: one dict lookup per point (the env is parsed
once and cached; tests that set env vars at runtime call
:func:`refresh`). Every firing bumps the ``fault.injected`` counter so
chaos runs are visible in telemetry.
"""
from __future__ import annotations

import os
import signal
import sys
import threading

from ..base import MXNetError

__all__ = ["FaultError", "fault_point", "inject", "clear", "refresh",
           "armed", "env_name"]

_PREFIX = "MXTPU_FAULT_"
_ACTIONS = ("die", "raise", "corrupt", "flag")


class FaultError(MXNetError):
    """An injected failure (never raised outside chaos testing)."""


class _Fault:
    __slots__ = ("action", "countdown", "times")

    def __init__(self, action, countdown=0, times=None):
        if action not in _ACTIONS:
            raise MXNetError(
                f"unknown fault action {action!r}: expected one of "
                f"{_ACTIONS} (spec grammar: action[:countdown[:times]])")
        self.action = action
        self.countdown = int(countdown)
        self.times = None if times is None else int(times)


_lock = threading.Lock()
_faults: dict[str, _Fault] = {}   # point name -> armed fault
_env_signature = None             # the MXTPU_FAULT_* env snapshot parsed


def env_name(point):
    """`ckpt.write.manifest` -> `MXTPU_FAULT_CKPT_WRITE_MANIFEST`."""
    return _PREFIX + point.upper().replace(".", "_").replace("-", "_")


def _parse_spec(spec):
    parts = str(spec).split(":")
    action = parts[0].strip().lower()
    countdown = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    times = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return _Fault(action, countdown, times)


def _env_faults():
    sig, faults = [], {}
    for key in sorted(os.environ):
        if not key.startswith(_PREFIX):
            continue
        val = os.environ[key]
        if not val:
            continue
        sig.append((key, val))
        name = key[len(_PREFIX):].lower().replace("_", ".")
        faults[name] = _parse_spec(val)
    return tuple(sig), faults


def refresh():
    """Re-read MXTPU_FAULT_* from the environment (tests that set env vars
    after import call this; :func:`fault_point` also detects changes)."""
    global _env_signature
    with _lock:
        sig, faults = _env_faults()
        # keep programmatic injections; env (re)defines only its own points
        _faults.update(faults)
        _env_signature = sig


def inject(point, action="raise", countdown=0, times=1):
    """Arm ``point`` programmatically (in-process tests). Unlike env specs
    the default is to fire ONCE (``times=1``)."""
    with _lock:
        _faults[point] = _Fault(action, countdown, times)


def clear(point=None):
    """Disarm one point (or all), including env-armed ones."""
    global _env_signature
    with _lock:
        if point is None:
            _faults.clear()
            # pin the signature to the current env so fault_point does not
            # immediately re-parse the same vars back in
            _env_signature = tuple(
                (k, os.environ[k]) for k in sorted(os.environ)
                if k.startswith(_PREFIX) and os.environ[k])
        else:
            _faults.pop(point, None)


def armed(point):
    """The armed fault spec for ``point`` (or None) — introspection."""
    f = _faults.get(point)
    return None if f is None else (f.action, f.countdown, f.times)


def _record_fire(point, action):
    # lazy import: chaos must stay importable before telemetry and costs
    # nothing at module load
    try:
        from .. import telemetry as tm

        tm.REGISTRY.counter("fault.injected").inc()
    except Exception:  # noqa: BLE001 — accounting never masks the fault
        pass


def fault_point(point):
    """Declare an injection point. Returns False when unarmed (the cheap,
    overwhelmingly common path), True when an armed ``corrupt`` fault
    fires (the call site applies its corruption), raises
    :class:`FaultError` for ``raise``, and SIGKILLs the process for
    ``die`` — an honest stand-in for ``kill -9`` / OOM-kill mid-write:
    no atexit hooks, no flushing, no finally blocks run."""
    global _env_signature
    if _env_signature is None or not _faults:
        # first call, or a test may have (un)set env vars since last parse
        sig = tuple((k, os.environ[k]) for k in sorted(os.environ)
                    if k.startswith(_PREFIX) and os.environ[k])
        if sig != _env_signature:
            refresh()
    fault = _faults.get(point)
    if fault is None:
        return False
    with _lock:
        fault = _faults.get(point)
        if fault is None:
            return False
        if fault.countdown > 0:
            fault.countdown -= 1
            return False
        if fault.times is not None:
            fault.times -= 1
            if fault.times <= 0:
                _faults.pop(point, None)
    _record_fire(point, fault.action)
    if fault.action == "die":
        sys.stderr.write(f"[chaos] SIGKILL at fault point {point!r}\n")
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
        # unreachable on POSIX; belt-and-braces for exotic platforms
        os._exit(137)
    if fault.action == "raise":
        raise FaultError(f"injected fault at {point!r}")
    return True  # corrupt/flag: the site applies/observes it
