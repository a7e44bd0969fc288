"""mxnet_tpu_torch.tune — the autotuned CUDA kernel tier.

Counterpart of ``mxnet_tpu/tune``. Offline: enumerate and measure tile
configs per (kernel, shape bucket, dtype) with :func:`autotune` (or
``tools/port_tune_kernels.py``); the winners persist in
``context.tuning_cache_path()``. Online: ``DecodePrograms.warmup`` calls
:func:`preload`; every kernel wrapper resolves its tile through
:func:`lookup`, which never tunes and never picks a config that lost its
measurement. ``"xla"`` in a config names the PyTorch library lowering (see
:mod:`.cache`).
"""
from .cache import (bucket, cache_path, enabled, entries, key_attention,
                    key_rows, lookup, missed, override, preload, record,
                    reset, resolve, save, status, trials)
from .tuner import (attention_spec, autotune, candidates, ladder_specs,
                    rows_spec, spec_from_key, spec_key, tune_one)

__all__ = [
    "enabled", "resolve", "lookup", "override", "record", "save", "preload",
    "reset", "missed", "entries", "status", "cache_path", "trials",
    "bucket", "key_attention", "key_rows",
    "attention_spec", "rows_spec", "ladder_specs", "spec_key",
    "spec_from_key", "candidates", "tune_one", "autotune",
]
