"""serve.Predictor: bucketed, dynamically batched inference of a hybridized
block, each bucket one CUDA graph.

Counterpart of ``mxnet_tpu/serve/predictor.py``, with its constructor and
semantics:

- **Shape bucketing** (:mod:`.bucketing`): one program per bucket of a
  ladder (powers of two up to ``max_batch`` by default); a batch pads with
  zero rows to its bucket and its outputs are sliced back; ``predict``
  splits a batch larger than ``max_batch`` into chunks.
- **Dynamic batching**: ``submit`` takes one item and returns a ``Future``;
  one dispatcher thread coalesces waiting items into a padded batch under
  the ``max_batch`` / ``max_wait_us`` policy. Batch N+1 runs before batch
  N's results are read: N's outputs are cloned out of the graph's buffers
  and their copy to pinned host memory is queued on the stream before N+1
  replays, so the replay cannot overwrite them.
- **Programs**: a copy of the block is traced once, in predict mode
  (``HybridBlock._serving_graph``), into a :class:`~mxnet_tpu_torch.
  cached_op.CachedOp`; each bucket is its ``aot_compile`` (on the card: a
  warm call and one CUDA graph, all the buckets' graphs in one memory
  pool). ``warmup()`` makes every bucket (after ``tune.preload()``), so no
  request pays a capture. ``warmup(path)`` writes a version-1 manifest
  (the reference's keys, ``torch_version`` in place of ``jax_version``);
  ``Predictor(block, manifest=...)`` adopts its ladder and input specs and
  warms at construction. ``cache_dir`` is only recorded: a CUDA graph does
  not persist across processes.
- **Weights**: the reference's predictor serves the immutable arrays it
  was built with. The port's parameters change in place, so the predictor
  serves a copy of the block, taken at construction, that nothing else
  calls: a later ``load_parameters``, ``cast`` or training step of the
  block changes the block's outputs and not the predictor's.
- **Robustness**: transient dispatch failures retry
  (``MXTPU_SERVE_RETRIES``, ``MXTPU_SERVE_RETRY_BACKOFF_MS``,
  ``MXTPU_SERVE_RETRY_MAX_MS``; chaos point ``serve.dispatch``); retries
  exhausted fail that batch's futures only; a crash of the dispatcher
  fails every queued and in-flight future with :class:`EngineDeadError`
  and marks the predictor unhealthy (``healthy``, ``_health``).
- **Accounting**: ``stats()`` (requests, batches, padding, occupancy, the
  programs and captures, latency p50/p99 from a
  :class:`~mxnet_tpu_torch.telemetry.Histogram`); the ``serve.*`` metrics
  of the port's registry move always (the port has no telemetry gate).

The predictor runs on its block's device and passes it explicitly: the
dispatcher thread enters that device's context, since ``with mx.cpu():``
scopes are thread-local. ``submit`` does host work only.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import Future

import numpy as onp
import torch

from .. import telemetry as _tm
from ..base import MXNetError, dtype_name, to_dtype
from ..cached_op import unflatten_out
from ..context import context_of, env_signature
from ..ndarray.ndarray import NDArray, _to_host
from ..testing import chaos
from .bucketing import bucket_ladder, padded_rows, pick_bucket, split_sizes
from .decode.engine import EngineDeadError, _env_int
from .decode.programs import _signature

__all__ = ["Predictor", "load_manifest"]

_STOP = object()


class _Request:
    __slots__ = ("rows", "future", "t0")

    def __init__(self, rows):
        self.rows = rows  # one host tensor per model input
        self.future = Future()
        self.t0 = time.perf_counter()


def load_manifest(path):
    """Read a warmup manifest written by ``Predictor.warmup(path)``."""
    with open(path) as fh:
        m = json.load(fh)
    if m.get("version") != 1:
        raise MXNetError(f"unsupported warmup manifest version in {path}: "
                         f"{m.get('version')!r}")
    return m


def _host_tensor(x):
    """``x`` (an NDArray, a tensor or anything numpy takes) as a tensor."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    a = onp.asarray(x)
    return torch.from_numpy(a if a.flags.c_contiguous else a.copy())


class Predictor:
    """Serve a hybridizable block behind bucketed, batched programs.

    Parameters
    ----------
    block : HybridBlock
        The model. A copy of it, taken at construction with its
        parameters, is traced once in predict mode and served.
    example : tensor, NDArray or array, or a tuple of them
        A representative batch (any leading batch size) fixing each input's
        item shape and dtype. May be omitted when ``manifest`` gives them.
    max_batch : int
        Largest device batch and the top bucket; larger ``predict`` batches
        split into chunks of it.
    buckets : list[int], optional
        An ascending ladder ending at ``max_batch``; default the powers of
        two up to it.
    max_wait_us : int
        How long the dispatcher holds an underfull batch open for more
        ``submit`` traffic.
    cache_dir : str, None or False
        Recorded in the manifest only.
    manifest : str or dict, optional
        A warmup manifest: its ladder and input specs are adopted and every
        bucket is made at construction.
    """

    def __init__(self, block, example=None, *, max_batch=64, buckets=None,
                 max_wait_us=2000, cache_dir=None, manifest=None):
        self.cache_dir = None if cache_dir in (None, False) \
            else str(cache_dir)
        manifest_dict = None
        if manifest is not None:
            manifest_dict = load_manifest(manifest) \
                if isinstance(manifest, str) else dict(manifest)
            max_batch = int(manifest_dict["max_batch"])
            buckets = [int(b) for b in manifest_dict["buckets"]]
        self.max_batch = int(max_batch)
        self.buckets = [int(b) for b in buckets] if buckets \
            else bucket_ladder(self.max_batch)
        if sorted(self.buckets) != self.buckets or \
                self.buckets[-1] != self.max_batch:
            raise MXNetError(
                f"bucket ladder must ascend to max_batch={self.max_batch}, "
                f"got {self.buckets}")
        self.max_wait_us = int(max_wait_us)

        # -- input spec ----------------------------------------------------
        if example is not None:
            examples = example if isinstance(example, (tuple, list)) \
                else (example,)
            examples = [_host_tensor(x) for x in examples]
            if any(x.dim() < 1 for x in examples):
                raise MXNetError("example inputs need a leading batch axis")
            self._item_shapes = [tuple(x.shape[1:]) for x in examples]
            self._dtypes = [x.dtype for x in examples]
        elif manifest_dict is not None:
            self._item_shapes = [tuple(s["item_shape"])
                                 for s in manifest_dict["inputs"]]
            self._dtypes = [to_dtype(s["dtype"])
                            for s in manifest_dict["inputs"]]
        else:
            raise MXNetError(
                "Predictor needs an example input (or a warmup manifest) "
                "to fix input shapes/dtypes")

        # -- trace the serving graph once, in predict mode -----------------
        if not hasattr(block, "_serving_graph"):
            raise MXNetError(
                f"Predictor requires a hybridizable block, got "
                f"{type(block).__name__} (plain Blocks have no traceable "
                "graph — subclass HybridBlock)")
        self.device = block.device
        self._on_card = self.device.type == "cuda"
        self._context = context_of(self.device)
        with self._context:
            cop, tree, self._params = block._serving_graph(
                tuple(self._zeros_batch(self.max_batch)))
        self._cop = cop
        self._tree = tree
        self._n_out = cop._n_main

        # -- program table -------------------------------------------------
        self._programs = {}     # bucket -> the CachedOp's program
        self._signatures = {}   # bucket -> "f32[8,16],..." input signature
        self._compile_lock = threading.Lock()

        # -- batcher state -------------------------------------------------
        self._q = queue.SimpleQueue()
        self._worker = None
        self._worker_lock = threading.Lock()
        self._closed = False
        self._dead = None       # dispatcher crash exception, once fatal
        self._inflight = None   # the double-buffered batch (crash cleanup)
        self._pending_batch = None  # popped but not yet dispatched (ditto)

        # transient dispatch failures retry before failing the futures
        self._retries = _env_int("MXTPU_SERVE_RETRIES", 2)
        self._retry_backoff_ms = _env_int("MXTPU_SERVE_RETRY_BACKOFF_MS", 10)
        self._retry_max_ms = _env_int("MXTPU_SERVE_RETRY_MAX_MS", 1000)

        # -- accounting (always on: these are the serving stats) -----------
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded_rows = 0
        self._n_batched_rows = 0  # rows that went through device batches
        self._occupancy_sum = 0.0
        self._latency_ms = _tm.Histogram("serve.latency_ms")
        self._stats_lock = threading.Lock()

        if manifest_dict is not None:
            self.warmup()

    # ------------------------------------------------------------------ gen
    def _zeros_batch(self, n):
        return [torch.zeros((n,) + shp, dtype=dt, device=self.device)
                for shp, dt in zip(self._item_shapes, self._dtypes)]

    def _check_dtype(self, i, got):
        want = self._dtypes[i]
        if got != want:
            raise MXNetError(
                f"input {i} dtype mismatch: predictor compiled for "
                f"{dtype_name(want)}, got {dtype_name(got)} — cast the "
                f"input or rebuild the Predictor with a {dtype_name(got)} "
                "example")

    # ------------------------------------------------------------- programs
    def _ensure_program(self, bucket):
        prog = self._programs.get(bucket)
        if prog is not None:
            return prog
        with self._compile_lock:
            prog = self._programs.get(bucket)
            if prog is not None:
                return prog
            examples = self._zeros_batch(bucket)
            prog = self._cop.aot_compile(*examples, *self._params)
            self._signatures[bucket] = _signature(
                [(tuple(x.shape), x.dtype) for x in examples])
            self._programs[bucket] = prog
            return prog

    def warmup(self, manifest_path=None):
        """Make every bucket's program (on the card: capture its graph);
        optionally write a manifest. After it, serving any batch size
        captures nothing. Tuned kernel tiles (``MXTPU_TUNE=1``) preload
        first, so every capture resolves its tiles from the persisted
        winners. Returns the manifest dict."""
        from ..tune import preload as _tune_preload

        _tune_preload()
        with self._context:
            for b in self.buckets:
                self._ensure_program(b)
        manifest = self._manifest_dict()
        if manifest_path:
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh, indent=1)
            os.replace(tmp, manifest_path)
        return manifest

    def _manifest_dict(self):
        return {
            "version": 1,
            "env_signature": env_signature(),
            "torch_version": torch.__version__,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "inputs": [{"item_shape": list(shp), "dtype": dtype_name(dt)}
                       for shp, dt in zip(self._item_shapes, self._dtypes)],
            "signatures": {str(b): s for b, s in
                           sorted(self._signatures.items())},
            "cache_dir": self.cache_dir,
            "created_unix": time.time(),
        }

    # -------------------------------------------------------------- running
    def _run_program(self, bucket, datas):
        """The bucket's program on ``datas`` (one padded batch an input);
        returns the main outputs, tensors of their own on the device."""
        return self._programs[bucket](*datas)[: self._n_out]

    def predict(self, data):
        """Synchronous bucketed forward of a whole batch.

        ``data``: a tensor, NDArray or array with a leading batch axis, or a
        tuple of them for multi-input models. Batches larger than
        ``max_batch`` split into chunks; every chunk pads to its bucket and
        the outputs are unpadded and concatenated back to exactly the input
        row count. Returns the block's output structure, as NDArrays on the
        predictor's device.
        """
        self._check_open()
        inputs = data if isinstance(data, (tuple, list)) else (data,)
        if len(inputs) != len(self._item_shapes):
            raise MXNetError(
                f"predictor compiled for {len(self._item_shapes)} inputs, "
                f"got {len(inputs)}")
        arrs = []
        for i, x in enumerate(inputs):
            x = _host_tensor(x)
            self._check_dtype(i, x.dtype)
            if tuple(x.shape[1:]) != self._item_shapes[i]:
                raise MXNetError(
                    f"input {i} item shape mismatch: predictor compiled "
                    f"for {self._item_shapes[i]}, got {tuple(x.shape[1:])}")
            arrs.append(x.to(self.device))
        n = arrs[0].shape[0]
        if any(a.shape[0] != n for a in arrs):
            raise MXNetError("all inputs must share the batch axis")

        chunk_flats, off = [], 0
        with self._context:
            for size in split_sizes(n, self.max_batch):
                bucket = pick_bucket(size, self.buckets)
                self._ensure_program(bucket)
                pad = padded_rows(size, bucket)
                chunk = []
                for a in arrs:
                    c = a[off:off + size]
                    if pad:
                        c = torch.cat([c, c.new_zeros((pad,) + c.shape[1:])])
                    chunk.append(c)
                outs = self._run_program(bucket, chunk)
                chunk_flats.append([o[:size] for o in outs])
                self._account_batch(size, bucket, qdepth=0)
                off += size
        if len(chunk_flats) == 1:
            flat = chunk_flats[0]
        else:
            flat = [torch.cat([c[j] for c in chunk_flats])
                    for j in range(self._n_out)]
        with self._stats_lock:
            self._n_requests += 1
        _tm.REGISTRY.counter("serve.requests").inc()
        return unflatten_out([NDArray(o) for o in flat], self._tree)

    def _check_open(self):
        if self._dead is not None:
            raise EngineDeadError(
                f"Predictor dispatcher crashed: {self._dead!r}"
            ) from self._dead
        if self._closed:
            raise MXNetError("Predictor is closed")

    # ------------------------------------------------------------ batching
    def submit(self, item):
        """Enqueue one request (a single item, no batch axis; a tuple of
        items for multi-input models) for dynamic batching; returns a
        ``concurrent.futures.Future`` resolving to the item's output (numpy,
        in the block's output structure; bfloat16 as ``ml_dtypes``'s where
        installed). Host work only."""
        self._check_open()
        items = item if isinstance(item, (tuple, list)) else (item,)
        if len(items) != len(self._item_shapes):
            raise MXNetError(
                f"predictor compiled for {len(self._item_shapes)} inputs, "
                f"got {len(items)}")
        rows = []
        for i, x in enumerate(items):
            x = _host_tensor(x)
            self._check_dtype(i, x.dtype)
            if tuple(x.shape) != self._item_shapes[i]:
                raise MXNetError(
                    f"submit() takes single items of shape "
                    f"{self._item_shapes[i]} for input {i}, got "
                    f"{tuple(x.shape)} — use predict() for whole batches")
            rows.append(x.detach().cpu())
        req = _Request(rows)
        with self._stats_lock:
            self._n_requests += 1
        _tm.REGISTRY.counter("serve.requests").inc()
        self._start_worker()
        self._q.put(req)
        return req.future

    def _start_worker(self):
        if self._worker is not None:
            return
        with self._worker_lock:
            if self._worker is None:
                t = threading.Thread(target=self._dispatch_loop,
                                     name="mxtpu-serve-dispatch",
                                     daemon=True)
                self._worker = t
                t.start()

    def _dispatch_loop(self):
        """Crash guard around the dispatcher: an uncaught error fails every
        queued and in-flight future with :class:`EngineDeadError` (the real
        cause chained) and marks the predictor dead — clients get an
        exception, never a hang."""
        try:
            with self._context:
                if self._on_card:
                    torch.cuda.set_device(self.device)
                self._dispatch_loop_impl()
        except BaseException as e:  # noqa: BLE001 — converted, never lost
            self._dispatcher_crashed(e)

    def _dispatcher_crashed(self, exc):
        self._dead = exc
        self._closed = True
        _tm.REGISTRY.counter("serve.scheduler_crashes").inc()
        err = EngineDeadError(f"Predictor dispatcher crashed: {exc!r}")
        err.__cause__ = exc
        pending, self._pending_batch = self._pending_batch, None
        inflight, self._inflight = self._inflight, None
        reqs = list(pending or ()) + (list(inflight[0]) if inflight else [])
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not _STOP:
                reqs.append(r)
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(err)

    def _dispatch_loop_impl(self):
        """Dispatcher: coalesce -> pad -> run; resolve the previous batch
        only after the next one is queued on the device (double
        buffering)."""
        inflight = None
        stopping = False
        while not stopping:
            self._inflight = inflight
            try:
                first = self._q.get_nowait() if inflight is not None \
                    else self._q.get()
            except queue.Empty:
                # no follow-up traffic: settle the in-flight batch now
                # rather than withholding results while the line is idle
                self._resolve(inflight)
                inflight = None
                continue
            if first is _STOP:
                break
            batch = [first]
            # popped requests live in neither the queue nor _inflight until
            # dispatch returns: expose them so a loop crash fails their
            # futures instead of orphaning them
            self._pending_batch = batch
            deadline = time.perf_counter() + self.max_wait_us * 1e-6
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stopping = True
                    break
                batch.append(nxt)
            current = self._dispatch(batch)
            self._pending_batch = None
            self._resolve(inflight)
            inflight = current
        self._resolve(inflight)
        # drain whatever arrived after the stop sentinel
        leftovers = []
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not _STOP:
                leftovers.append(r)
        while leftovers:
            chunk, leftovers = leftovers[:self.max_batch], \
                leftovers[self.max_batch:]
            self._pending_batch = chunk
            out = self._dispatch(chunk)
            self._pending_batch = None
            self._resolve(out)

    def _dispatch(self, batch):
        """Pad the coalesced requests into one batch, run the bucket's
        program and queue the outputs' copy to the host. Returns
        ``(requests, host outputs, bucket, dispatch time, event)``, or None
        when the batch failed (its futures then hold the error)."""
        try:
            k = len(batch)
            bucket = pick_bucket(k, self.buckets)
            self._ensure_program(bucket)
            bufs = []
            for i, (shp, dt) in enumerate(zip(self._item_shapes,
                                              self._dtypes)):
                buf = torch.zeros((bucket,) + shp, dtype=dt,
                                  pin_memory=self._on_card)
                torch.stack([req.rows[i] for req in batch], out=buf[:k])
                bufs.append(buf)
            t_disp = time.perf_counter()
            outs = self._run_retry(bucket, bufs)
            host = [torch.empty(o.shape, dtype=o.dtype,
                                pin_memory=self._on_card)
                    .copy_(o, non_blocking=self._on_card) for o in outs]
            event = None
            if self._on_card:
                event = torch.cuda.Event()
                event.record()
            self._account_batch(k, bucket, qdepth=self._q.qsize())
            return batch, host, bucket, t_disp, event
        except Exception as e:  # noqa: BLE001 — fail the futures, not the loop
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return None

    def _run_retry(self, bucket, datas):
        """One program run behind the transient-failure retry policy
        (``MXTPU_SERVE_RETRIES`` retries, exponential backoff capped at
        ``MXTPU_SERVE_RETRY_MAX_MS``); ``serve.dispatch`` is the chaos
        injection site. A device out-of-memory error is not retried.
        Exhaustion fails this batch's futures only — the dispatcher itself
        stays up for later traffic."""
        attempt = 0
        while True:
            try:
                chaos.fault_point("serve.dispatch")
                return self._run_program(bucket, datas)
            except torch.cuda.OutOfMemoryError:
                raise
            except Exception:  # noqa: BLE001 — bounded retries
                if attempt >= self._retries:
                    raise
                attempt += 1
                _tm.REGISTRY.counter("serve.retries").inc()
                delay_ms = min(self._retry_backoff_ms * (1 << (attempt - 1)),
                               self._retry_max_ms)
                time.sleep(delay_ms * 1e-3)

    def _resolve(self, inflight):
        """Wait for an in-flight batch's host copy and complete its futures
        with per-row outputs."""
        if inflight is None:
            return
        batch, host, bucket, t_disp, event = inflight
        try:
            if event is not None:
                event.synchronize()
            rows = [_to_host(h) for h in host]
        except Exception as e:  # noqa: BLE001
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        now = time.perf_counter()
        _tm.REGISTRY.timer(f"serve.bucket{bucket}.call").record(now - t_disp)
        hist = _tm.REGISTRY.histogram("serve.latency_ms")
        for i, req in enumerate(batch):
            req.future.set_result(unflatten_out([r[i] for r in rows],
                                                self._tree))
            ms = (now - req.t0) * 1e3
            self._latency_ms.record(ms)
            hist.record(ms)

    # ----------------------------------------------------------- accounting
    def _account_batch(self, k, bucket, qdepth):
        pad = padded_rows(k, bucket)
        occ = k / bucket
        with self._stats_lock:
            self._n_batches += 1
            self._n_padded_rows += pad
            self._n_batched_rows += k
            self._occupancy_sum += occ
        reg = _tm.REGISTRY
        reg.counter("serve.batches").inc()
        reg.gauge("serve.queue_depth").set(qdepth)
        reg.gauge("serve.batch_occupancy").set(occ)
        reg.gauge("serve.padding_waste").set(pad / bucket)
        reg.counter("serve.padded_rows").inc(pad)
        reg.counter("serve.batched_rows").inc(k)

    def stats(self):
        """Serving accounting: request, batch and program counts, mean
        occupancy, padding waste, the programs' captures (programs made,
        on the CPU) and graph-pool bytes, and latency percentiles (ms) over
        recent dynamic-batch traffic."""
        with self._stats_lock:
            n_b = self._n_batches
            pad, rows = self._n_padded_rows, self._n_batched_rows
            occ = self._occupancy_sum / n_b if n_b else 0.0
        p50, p99 = self._latency_ms.percentiles(50, 99)
        return {
            "requests": self._n_requests,
            "batches": n_b,
            "batched_rows": rows,
            "padded_rows": pad,
            "padding_waste": pad / (pad + rows) if pad + rows else 0.0,
            "mean_occupancy": occ,
            "programs": sorted(self._programs),
            "captures": self._cop._captures,
            "pool_bytes": self._cop.pool_bytes(),
            "latency_ms_p50": p50,
            "latency_ms_p99": p99,
            "dead": self._dead is not None,
        }

    # -------------------------------------------------------------- health
    def _health(self):
        if self._dead is not None:
            return False, f"dispatcher crashed: {self._dead!r}"
        return True, {"closed": self._closed}

    @property
    def healthy(self):
        return self._dead is None

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Stop the dispatcher (idempotent). Outstanding futures resolve
        before the worker exits; later ``submit``/``predict`` raise."""
        if self._closed:
            return
        self._closed = True
        worker = self._worker
        if worker is not None:
            self._q.put(_STOP)
            worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
