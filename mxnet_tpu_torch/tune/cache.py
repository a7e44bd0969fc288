"""Persistent kernel-tuning cache + in-process lookup tier.

Counterpart of ``mxnet_tpu/tune/cache.py``. The autotuner
(``tune/tuner.py``) measures tile candidates for each CUDA kernel family
(``flash_fwd``, ``flash_bwd``, ``layer_norm``, ``softmax``) and records the
winner here, keyed by

    ``<kernel>|<shape-bucket>.<dtype>[.flags]``

where every shape dimension is rounded up to its power-of-two bucket — the
same ladder the decode engine's programs run at, so one offline sweep covers
every steady-state call. Keys and the file schema are the reference's.

**The config ``"xla"``** keeps the reference's spelling in the cache schema
and in :func:`resolve`'s results. In the port it means *the PyTorch library
lowering* of the same function: ``scaled_dot_product_attention`` with the
boolean mask (flash forward), ``torch.autograd.grad`` through it (flash
backward), ``F.layer_norm`` and ``torch.softmax``. A wrapper takes it only on
CUDA tensors, only while tuning is on, and counts every such call.

Two tiers:

- **In-process LRU** (``resolve``): with tuning enabled a miss returns
  ``"xla"`` — never silently slower than the untuned default — and is
  counted (``tune.cache_misses`` + ``tune.fallback_xla``). The reference
  resolves once per trace; the port's programs are eager, so the kernel
  wrappers go through :func:`lookup`, a per-process memo that stands in for
  the trace: a key resolves, and moves the counters, once. ``reset()`` and
  ``record()`` clear it; an :func:`override` bypasses it. With tuning off a
  call costs one environment read. The wrappers resolve CUDA calls only
  (``cuda_kernels._TUNED_DEVICES``), as the reference resolves only where
  Pallas runs, so a CPU process logs no misses.
- **Versioned JSON file** (``save``/``preload``): at
  ``context.tuning_cache_path()``, keyed by ``context.env_signature()``
  (interpreter, torch and CUDA versions, card name, a digest of the kernel
  sources). A file written under a different signature, an unknown schema
  version, or a corrupt entry is skipped with a warning and re-tuned —
  stale winners are never replayed into a different environment.
  Production processes ``preload()`` at warmup and never tune online
  (``tune.measurements`` stays flat).

Counters/gauges are registered unconditionally: they move only when a key
first resolves or the tuner measures, never per call.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from collections import OrderedDict

import numpy as onp
import torch

from .. import telemetry as _tm

SCHEMA_VERSION = 1
_LRU_CAP = 4096

_C_HITS = _tm.counter("tune.cache_hits")
_C_MISSES = _tm.counter("tune.cache_misses")
_C_FALLBACK = _tm.counter("tune.fallback_xla")
_C_CORRUPT = _tm.counter("tune.cache_corrupt")
_C_MEASURE = _tm.counter("tune.measurements")
_G_ENTRIES = _tm.gauge("tune.entries")

_lock = threading.RLock()
_lru = OrderedDict()            # (kernel, key) -> entry dict
_missed = OrderedDict()         # (kernel, key) -> None, insertion-ordered
_memo = {}                      # lookup()'s keys -> resolved config
_state = {"loaded": False, "dirty": False, "path": None}
_tls = threading.local()
_MISSING = object()


def enabled() -> bool:
    """True when the tuned kernel tier is on (``MXTPU_TUNE``)."""
    return os.environ.get("MXTPU_TUNE", "").lower() in ("1", "true", "on")


def trials() -> int:
    """Measurement trials per candidate (``MXTPU_TUNE_TRIALS``)."""
    try:
        return max(1, int(os.environ.get("MXTPU_TUNE_TRIALS", "") or 3))
    except ValueError:
        return 3


def cache_path():
    from ..context import tuning_cache_path

    return tuning_cache_path()


def _env_signature():
    from ..context import env_signature

    return env_signature()


def _dtype_name(dtype) -> str:
    """``float32`` from torch.float32, numpy dtypes or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return onp.dtype(dtype).name
    except TypeError:
        return str(dtype)      # bfloat16 without ml_dtypes


# ------------------------------------------------------------------- keys
def bucket(n) -> int:
    """Smallest power of two >= n (the serving ladder's bucket rule)."""
    n = max(1, int(n))
    p = 1
    while p < n:
        p <<= 1
    return p


def key_attention(kernel, q_shape, k_shape, dtype, causal, seg) -> str:
    b, h, tq, d = q_shape
    tk = k_shape[2]
    return (f"{kernel}|bh{bucket(b * h)}.tq{bucket(tq)}.tk{bucket(tk)}"
            f".d{bucket(d)}.{_dtype_name(dtype)}"
            f".c{int(bool(causal))}.s{int(bool(seg))}")


def key_rows(kernel, rows, d, dtype) -> str:
    return (f"{kernel}|rows{bucket(rows)}.d{bucket(d)}"
            f".{_dtype_name(dtype)}")


# -------------------------------------------------------------- validation
def _config_ok(cfg) -> bool:
    if cfg == "xla":
        return True
    if not isinstance(cfg, dict) or not cfg:
        return False
    return all(isinstance(k, str) and isinstance(v, int) and v > 0
               for k, v in cfg.items())


def _entry_ok(key, ent) -> bool:
    return (isinstance(key, str) and "|" in key and isinstance(ent, dict)
            and _config_ok(ent.get("config")))


# ------------------------------------------------------------ file loading
def _load_locked():
    if _state["loaded"]:
        return
    _state["loaded"] = True
    path = cache_path()
    _state["path"] = path
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        _C_CORRUPT.inc()
        warnings.warn(
            f"kernel tuning cache {path} is unreadable ({e}); ignoring it "
            "— re-run the tuner (tools/port_tune_kernels.py) to rebuild",
            RuntimeWarning, stacklevel=3)
        return
    if not isinstance(doc, dict) or doc.get("version") != SCHEMA_VERSION:
        _C_CORRUPT.inc()
        warnings.warn(
            f"kernel tuning cache {path} has schema version "
            f"{doc.get('version') if isinstance(doc, dict) else '?'!r} "
            f"(this build reads {SCHEMA_VERSION}); ignoring it — stale "
            "winners are re-tuned, not replayed", RuntimeWarning,
            stacklevel=3)
        return
    sig = _env_signature()
    if doc.get("env_signature") != sig:
        warnings.warn(
            f"kernel tuning cache {path} was written under a different "
            "environment signature (interpreter/torch/CUDA/card/kernel "
            "sources changed); "
            "not reusing its winners", RuntimeWarning, stacklevel=3)
        return
    for key, ent in (doc.get("entries") or {}).items():
        if not _entry_ok(key, ent):
            _C_CORRUPT.inc()
            warnings.warn(
                f"skipping corrupt tuning-cache entry {key!r} in {path}; "
                "it will take the library lowering until re-tuned",
                RuntimeWarning,
                stacklevel=3)
            continue
        _lru_put_locked((key.split("|", 1)[0], key), ent)
    _G_ENTRIES.set(float(len(_lru)))


def _lru_put_locked(k, ent):
    _lru[k] = ent
    _lru.move_to_end(k)
    while len(_lru) > _LRU_CAP:
        _lru.popitem(last=False)


# ----------------------------------------------------------------- resolve
def resolve(kernel, key):
    """Config lookup for one (kernel, key); moves the counters every call
    (the kernel wrappers go through the memo of :func:`lookup`).

    Returns ``"default"`` (tuning off: use the env-default tiles), a
    config dict (tuned winner), or ``"xla"`` (tuned loss OR miss — use
    the library lowering, never a possibly-slower untuned kernel).
    A thread-local :func:`override` wins over everything (measurement /
    bench / test hook) and moves no counters.
    """
    ov = getattr(_tls, "overrides", None)
    if ov:
        cfg = ov.get(kernel, _MISSING)
        if cfg is not _MISSING:
            return cfg
    if not enabled():
        return "default"
    with _lock:
        _load_locked()
        ent = _lru.get((kernel, key))
        if ent is not None:
            _lru.move_to_end((kernel, key))
        else:
            if len(_missed) < _LRU_CAP:
                _missed[(kernel, key)] = None
    if ent is None:
        _C_MISSES.inc()
        _C_FALLBACK.inc()
        return "xla"
    _C_HITS.inc()
    cfg = ent["config"]
    if cfg == "xla":
        _C_FALLBACK.inc()
        return "xla"
    return dict(cfg)


def lookup(kernel, call_key, make_key):
    """:func:`resolve` for the kernel wrappers, memoized per process.

    ``call_key`` is a cheap hashable of the call (kernel, exact shapes,
    dtype, flags); ``make_key()`` builds the bucketed cache key the first
    time it is seen. A bucketed key resolves (and moves the counters) once
    until :func:`reset` or :func:`record` clears the memo; an override
    wins over the memo and moves nothing."""
    ov = getattr(_tls, "overrides", None)
    if ov:
        cfg = ov.get(kernel, _MISSING)
        if cfg is not _MISSING:
            return cfg
    if not enabled():
        return "default"
    cfg = _memo.get(call_key)
    if cfg is None:
        key = (kernel, make_key())
        cfg = _memo.get(key)
        if cfg is None:
            cfg = _memo[key] = resolve(kernel, key[1])
        _memo[call_key] = cfg
    return cfg


def missed():
    """(kernel, key) pairs that resolved to a miss since the last
    ``reset()`` — the offline-tuning worklist: warm the serving process
    once with ``MXTPU_TUNE=1``, read this, tune exactly these buckets."""
    with _lock:
        return list(_missed)


@contextlib.contextmanager
def override(kernel, config):
    """Force ``config`` (dict | ``"xla"`` | ``"default"``) for ``kernel``
    on this thread — how the tuner times each candidate."""
    if not _config_ok(config) and config != "default":
        raise ValueError(f"invalid tuning override for {kernel}: {config!r}")
    ov = getattr(_tls, "overrides", None)
    if ov is None:
        ov = _tls.overrides = {}
    prev = ov.get(kernel, _MISSING)
    ov[kernel] = config
    try:
        yield
    finally:
        if prev is _MISSING:
            del ov[kernel]
        else:
            ov[kernel] = prev


# ------------------------------------------------------------------ record
def record(kernel, key, config, **stats):
    """Install a tuned winner in the process LRU (marking the cache dirty
    for the next ``save``, clearing the memo) and surface it as
    ``tune.winner.*`` gauges."""
    if not _config_ok(config):
        raise ValueError(f"invalid tuned config for {kernel}: {config!r}")
    ent = {"config": config, **stats, "created_unix": time.time()}
    with _lock:
        _load_locked()
        _lru_put_locked((kernel, key), ent)
        _missed.pop((kernel, key), None)
        _memo.clear()
        _state["dirty"] = True
        _G_ENTRIES.set(float(len(_lru)))
    if isinstance(config, dict):
        for p, v in config.items():
            _tm.gauge(f"tune.winner.{kernel}.{p}").set(float(v))
    else:
        _tm.gauge(f"tune.winner.{kernel}.xla").set(1.0)
    return ent


def count_measurement(n=1):
    _C_MEASURE.inc(n)


def measurements() -> int:
    return int(_C_MEASURE.value)


# -------------------------------------------------------------- save/load
def save(path=None):
    """Atomically write the in-process entries, merged over any valid
    entries already on disk (last writer's keys win). Returns the path,
    or None when persistence is disabled."""
    with _lock:
        _load_locked()
        if path is None:
            path = _state["path"] or cache_path()
        if not path:
            return None
        sig = _env_signature()
        entries = {}
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if (isinstance(doc, dict)
                    and doc.get("version") == SCHEMA_VERSION
                    and doc.get("env_signature") == sig):
                entries.update({k: e for k, e in
                                (doc.get("entries") or {}).items()
                                if _entry_ok(k, e)})
        except (OSError, ValueError):
            pass
        entries.update({key: ent for (_, key), ent in _lru.items()})
        doc = {
            "version": SCHEMA_VERSION,
            "env_signature": sig,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "entries": entries,
            "created_unix": time.time(),
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _state["dirty"] = False
    return path


def preload() -> int:
    """Load the persistent winners into the in-process LRU (no-op when
    tuning is off) — ``DecodePrograms.warmup`` calls this so every
    ladder bucket resolves from memory and the serving process never
    touches the tuner. Returns the entry count."""
    if not enabled():
        return 0
    with _lock:
        _load_locked()
        _G_ENTRIES.set(float(len(_lru)))
        return len(_lru)


def entries() -> dict:
    """Snapshot of the resident entries: {``kernel|key``: entry}."""
    with _lock:
        _load_locked()
        return {key: dict(ent) for (_, key), ent in _lru.items()}


def reset():
    """Drop the in-process tier (LRU + memo + loaded latch + miss log) —
    the fresh-process simulation for tests. The persistent file and the
    telemetry counters are untouched."""
    with _lock:
        _lru.clear()
        _memo.clear()
        _missed.clear()
        _state["loaded"] = False
        _state["dirty"] = False
        _state["path"] = None


def status() -> dict:
    with _lock:
        return {
            "enabled": enabled(),
            "entries": len(_lru),
            "loaded": _state["loaded"],
            "path": _state["path"] if _state["loaded"] else cache_path(),
            "hits": int(_C_HITS.value),
            "misses": int(_C_MISSES.value),
            "fallback_xla": int(_C_FALLBACK.value),
            "measurements": int(_C_MEASURE.value),
        }
