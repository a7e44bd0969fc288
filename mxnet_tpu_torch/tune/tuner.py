"""Tile autotuner for the CUDA kernel families.

Counterpart of ``mxnet_tpu/tune/tuner.py``. For each spec (kernel family +
shape bucket + dtype + flags) this enumerates a small candidate space — the
library lowering (``"xla"``), the env-default tile, and a power-of-two grid
from each kernel's legal set (``block_q``/``block_k`` from
``cuda_kernels.FLASH_BLOCKS`` for attention, ``block_rows`` from
``cuda_kernels.ROW_BLOCKS`` for the row kernels; the port's own grid: the
Mosaic floors of the reference, 8 and 128, mean nothing on this card) —
and measures them with the reference's discipline: candidates run
INTERLEAVED round-robin for N rounds and each keeps its minimum, so slow
drift hits all candidates equally and the min strips the noise floor. The
winner (which may be ``"xla"``) lands in the tuning cache
(:mod:`tune.cache`) for ``save()``/``preload()``.

Timing on the card is device time: each candidate's ``reps`` calls are
captured once in a ``torch.cuda.CUDAGraph`` under its ``cache.override``
(the wrappers resolve their tile while being captured; the kernels launch
through ctypes on torch's current stream, which the capture records), and
each round replays the graph between two CUDA events. The wrappers' host
time (~50-80 µs a call) never enters the comparison. With ``device="cpu"``
the tuner is a mechanism check for the tests: it times the plain versions
with ``perf_counter``.

Nothing here runs in a serving process: production preloads the cache at
warmup and only ever resolves.
"""
from __future__ import annotations

import contextlib
import time

import numpy as onp
import torch

from ..base import to_dtype
from ..context import resolve_device
from . import cache

_FAMILIES = ("flash_fwd", "flash_bwd", "layer_norm", "softmax")


# --------------------------------------------------------------- specs
def attention_spec(kernel, b, h, tq, tk, d, dtype="float32", causal=True,
                   seg=False):
    assert kernel in ("flash_fwd", "flash_bwd"), kernel
    return {"kernel": kernel, "b": int(b), "h": int(h), "tq": int(tq),
            "tk": int(tk), "d": int(d), "dtype": str(dtype),
            "causal": bool(causal), "seg": bool(seg)}


def rows_spec(kernel, rows, d, dtype="float32"):
    assert kernel in ("layer_norm", "softmax"), kernel
    return {"kernel": kernel, "rows": int(rows), "d": int(d),
            "dtype": str(dtype)}


def spec_key(spec):
    if spec["kernel"] in ("flash_fwd", "flash_bwd"):
        shape = (spec["b"], spec["h"], spec["tq"], spec["d"])
        kshape = (spec["b"], spec["h"], spec["tk"], spec["d"])
        return cache.key_attention(spec["kernel"], shape, kshape,
                                   spec["dtype"], spec["causal"],
                                   spec["seg"])
    return cache.key_rows(spec["kernel"], spec["rows"], spec["d"],
                          spec["dtype"])


def ladder_specs(batch_ladder, len_ladder, num_heads, head_dim, units,
                 dtype="float32", seg=True, families=("flash_fwd",
                                                      "layer_norm")):
    """Specs covering a serving ladder: one attention spec per (B, T)
    rung and one row-wise spec per distinct B*T row count — the shape
    buckets the decode engine's programs run at, so a sweep over these
    leaves no warmup-time cache miss."""
    specs = []
    rows_seen = set()
    for b in batch_ladder:
        for t in len_ladder:
            for fam in families:
                if fam in ("flash_fwd", "flash_bwd"):
                    specs.append(attention_spec(
                        fam, b, num_heads, t, t, head_dim, dtype,
                        causal=True, seg=seg))
            rows = cache.bucket(b * t)
            if rows not in rows_seen:
                rows_seen.add(rows)
                for fam in families:
                    if fam in ("layer_norm", "softmax"):
                        specs.append(rows_spec(fam, rows, units, dtype))
    return specs


def spec_from_key(key):
    """Reconstruct a tunable spec from a cache key (e.g. one reported by
    ``cache.missed()``) — closes the loop: warm a serving process with
    ``MXTPU_TUNE=1``, read the missed keys, tune exactly those buckets.
    Keys are already bucketed, so the spec measures the bucket shape the
    serving ladder runs."""
    kernel, rest = key.split("|", 1)
    parts = rest.split(".")
    fields = {}
    tail = []
    for p in parts:
        i = 0
        while i < len(p) and not p[i].isdigit():
            i += 1
        if 0 < i < len(p) and p[i:].isdigit():
            fields[p[:i]] = int(p[i:])
        else:
            tail.append(p)
    dtype = tail[0] if tail else "float32"
    if kernel in ("flash_fwd", "flash_bwd"):
        return attention_spec(kernel, 1, fields["bh"], fields["tq"],
                              fields["tk"], fields["d"], dtype,
                              causal=bool(fields.get("c", 0)),
                              seg=bool(fields.get("s", 0)))
    return rows_spec(kernel, fields["rows"], fields["d"], dtype)


# ---------------------------------------------------------- candidates
def _grid(legal, n, count):
    """Up to ``count`` tiles of ``legal`` from the largest <= n downward
    (the smallest legal tile where none fits)."""
    fit = [t for t in sorted(legal, reverse=True) if t <= n]
    return fit[:count] or [min(legal)]


def candidates(spec, max_per_axis=3):
    """Candidate configs for a spec: the library lowering, the env-default
    tile, and a power-of-two grid from the kernel's legal set below the
    (bucketed) shape."""
    from ..ops import cuda_kernels as ck

    cands = [("xla", "xla")]
    if spec["kernel"] in ("flash_fwd", "flash_bwd"):
        tq = cache.bucket(spec["tq"])
        tk = cache.bucket(spec["tk"])
        dflt = {"block_q": ck.flash_block_q(), "block_k": ck.flash_block_k()}
        cands.append(("default", dflt))
        for bq in _grid(ck.FLASH_BLOCKS, tq, max_per_axis):
            for bk in _grid(ck.FLASH_BLOCKS, tk, max_per_axis):
                cfg = {"block_q": bq, "block_k": bk}
                if cfg != dflt:
                    cands.append((f"q{bq}k{bk}", cfg))
    else:
        rows = cache.bucket(spec["rows"])
        dflt = {"block_rows": ck.DEFAULT_BLOCK_ROWS}
        cands.append(("default", dflt))
        for br in _grid(ck.ROW_BLOCKS, rows, max_per_axis):
            cfg = {"block_rows": br}
            if cfg != dflt:
                cands.append((f"r{br}", cfg))
    return cands


# --------------------------------------------------------- measurement
def _build_fn(spec, device):
    """A no-argument callable for a spec, on ``device``, inputs from numpy
    seed 0. It calls the kernel wrappers with unpinned tiles, so calling it
    under ``cache.override`` pins a candidate."""
    from ..ops import cuda_kernels as ck

    rng = onp.random.RandomState(0)
    dtype = to_dtype(spec["dtype"])

    def tensor(*shape):
        return torch.from_numpy(rng.randn(*shape).astype("float32")).to(
            device, dtype)

    if spec["kernel"] in ("flash_fwd", "flash_bwd"):
        b, h, tq, tk, d = (spec["b"], spec["h"], spec["tq"], spec["tk"],
                           spec["d"])
        q, k, v = tensor(b, h, tq, d), tensor(b, h, tk, d), tensor(b, h, tk, d)
        causal = spec["causal"]
        qs = ks = None
        if spec["seg"]:
            # two segments per row — exercises the masked kernel variant
            n = max(tq, tk)
            seg = torch.from_numpy(
                (onp.arange(n) >= n // 2).astype(onp.int32)).to(device)
            qs = seg[:tq].expand(b, tq).contiguous()
            ks = seg[:tk].expand(b, tk).contiguous()

        if spec["kernel"] == "flash_fwd":
            def fwd():
                return ck.flash_attention(q, k, v, None, causal,
                                          q_segment_ids=qs,
                                          kv_segment_ids=ks)

            return fwd

        qg, kg, vg = (t.requires_grad_() for t in (q, k, v))
        g = torch.ones((b, h, tq, d), dtype=dtype, device=device)

        def bwd():
            # one forward under the pinned default, then the backward the
            # candidate decides: the dK/dV and dQ kernels or the library's
            out = ck.flash_attention(qg, kg, vg, None, causal,
                                     q_segment_ids=qs, kv_segment_ids=ks)
            return torch.autograd.grad(out, (qg, kg, vg), g)

        return bwd

    rows, d = spec["rows"], spec["d"]
    x = tensor(rows, d)
    if spec["kernel"] == "layer_norm":
        gamma = torch.from_numpy((rng.rand(d) + 0.5).astype("float32")).to(
            device, dtype)
        beta = tensor(d)
        return lambda: ck.fused_layer_norm(x, gamma, beta)
    return lambda: ck.fused_softmax(x)


def _pin_kernels(spec):
    """The families held at their env default while one candidate varies —
    a flash_bwd measurement must not have its forward resolve a different
    (possibly missing) tuned config mid-sweep."""
    return [f for f in _FAMILIES if f != spec["kernel"]]


def _capture(fn, reps):
    """``reps`` calls of ``fn`` captured in one CUDA graph, after two calls
    on a side stream (builds, allocator and autograd state, as torch's
    capture recipe asks)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return graph


def _replay_seconds(graph, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _host_seconds(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def tune_one(spec, trials=None, max_per_axis=3, verbose=None, device=None,
             reps=20):
    """Measure every candidate for one spec and record the winner.

    On the card each candidate's time is the device time of one call, from
    CUDA-graph replays of ``reps`` calls; with ``device="cpu"`` the host
    time of the plain versions. Returns {kernel, key, winner, config,
    best_us, default_us, xla_us, speedup_vs_default, trials, candidates:
    [{name, config, best_us}]}.
    """
    dev = resolve_device(device)
    trials = trials if trials is not None else cache.trials()
    key = spec_key(spec)
    kernel = spec["kernel"]
    fn = _build_fn(spec, dev)
    cands = candidates(spec, max_per_axis=max_per_axis)

    with contextlib.ExitStack() as stack:
        for other in _pin_kernels(spec):
            stack.enter_context(cache.override(other, "default"))
        timed = []
        for name, cfg in cands:
            if dev.type == "cuda":
                with cache.override(kernel, cfg):
                    graph = _capture(fn, reps)
                run = (lambda g=graph: _replay_seconds(g, reps))
            else:
                def run(cfg=cfg):
                    with cache.override(kernel, cfg):
                        return _host_seconds(fn, reps)
            timed.append([name, cfg, run, float("inf")])

        # interleaved rounds, per-candidate min
        for _ in range(trials):
            for ent in timed:
                dt = ent[2]()
                cache.count_measurement()
                ent[3] = min(ent[3], dt)
    # the graphs (and the memory their pools hold) go with the closures
    rows = [(name, cfg, best) for name, cfg, _, best in timed]
    del timed, fn

    by_name = {name: best for name, _, best in rows}
    win_name, win_cfg, win_t = min(rows, key=lambda e: e[2])
    default_us = by_name.get("default", float("inf")) * 1e6
    result = {
        "kernel": kernel,
        "key": key,
        "winner": win_name,
        "config": win_cfg,
        "best_us": win_t * 1e6,
        "default_us": default_us,
        "xla_us": by_name.get("xla", float("inf")) * 1e6,
        "speedup_vs_default": (default_us / (win_t * 1e6)
                               if win_t > 0 else 1.0),
        "trials": trials,
        "device": str(dev),
        "candidates": [{"name": name, "config": cfg, "best_us": best * 1e6}
                       for name, cfg, best in rows],
    }
    cache.record(kernel, key, win_cfg,
                 winner=win_name,
                 best_us=result["best_us"],
                 default_us=result["default_us"],
                 trials=trials)
    if verbose:
        verbose(f"tune {key}: winner={win_name} "
                f"best={result['best_us']:.1f}us "
                f"default={result['default_us']:.1f}us "
                f"({result['speedup_vs_default']:.2f}x)")
    return result


def autotune(specs, trials=None, max_per_axis=3, save=True, verbose=None,
             device=None):
    """Tune a list of specs (see :func:`attention_spec`/:func:`rows_spec`
    /:func:`ladder_specs`), persist the winners, return the per-spec
    results."""
    results = [tune_one(s, trials=trials, max_per_axis=max_per_axis,
                        verbose=verbose, device=device)
               for s in specs]
    if save and results:
        cache.save()
    return results
