"""DecodeEngine: continuous batching over the three decode program families.

Counterpart of ``mxnet_tpu/serve/decode/engine.py:161``. The scheduler is
the reference's: each tick it expires deadlines, admits pending requests
into free slots (radix prefix lookup, page allocation, then the prefill or
prefix-join program, bucketed batch x length), runs one decode tick for all
slots (verifying K-1 drafted tokens per slot when speculation is on),
commits the accepted tokens and retires finished requests. KV memory is a
shared pool of pages on the device; ``submit`` is thread-safe and returns a
:class:`DecodeStream`. Load past the queue budget, or past its deadline
before it reaches a slot, is shed with :class:`ShedError`; a request whose
deadline expires mid-generation finishes with ``expired=True``.

Each program run goes through the reference's retry policy: a failure
retries with capped exponential backoff (``MXTPU_SERVE_RETRIES`` /
``MXTPU_SERVE_RETRY_BACKOFF_MS`` / ``MXTPU_SERVE_RETRY_MAX_MS``;
``serve.retries`` counts them). A run is safe to repeat: its writes are a
function of its operands and of pool cells it does not write. A
``torch.cuda.OutOfMemoryError`` is not retried. A failure that survives
the retries is a scheduler crash, which never hangs a client: every live,
pending and queued stream finishes with :class:`EngineDeadError` carrying
the cause, ``healthy`` turns false, ``serve.scheduler_crashes`` counts it
and later ``submit`` raises. ``drain()`` finishes accepted work while new
submissions shed; ``resume()`` reopens the gate. Chaos points:
``decode.prefill``, ``decode.tick`` (:mod:`mxnet_tpu_torch.testing.chaos`).
Counters and gauges (``serve.*``, ``mem.kv_cache_bytes``) move in the
port's telemetry registry under the reference's names.

On the card every program bucket is a CUDA graph (:mod:`.programs`):
``warmup()`` captures the whole table, so serving captures nothing, and
``warmup(manifest_path)`` also writes the warmup manifest.
``DecodeEngine(..., manifest=path)`` adopts a manifest's geometry and warms
at construction. ``cache_dir`` is recorded in the manifest and points at
nothing else: a CUDA graph does not persist across processes.

The engine runs on the GPU unless ``device="cpu"`` is passed; the model's
parameters must already live on that device. Not ported yet: ``programs``
(serving from an export needs the graph layer) and ``tp`` (they raise when
given), and the telemetry layer beyond the registry (exporter, watchdog,
stall heartbeats, request traces); ``stats()`` keeps its own TTFT/TPOT
histograms.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque

import numpy as onp
import torch

from ... import telemetry as _tm
from ...base import MXNetError
from ...context import resolve_device
from ...testing import chaos
from ..bucketing import pick_bucket
from .cache import PagedKVCache
from .prefix import RadixPrefixCache
from .programs import DecodePrograms, _check_manifest, load_decode_manifest
from .spec import accept_longest_prefix, make_draft

__all__ = ["DecodeEngine", "DecodeStream", "ShedError", "EngineDeadError",
           "Histogram"]

_STOP = object()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class ShedError(MXNetError):
    """The engine refused (or dropped) a request to protect latency."""


class EngineDeadError(MXNetError):
    """The scheduler thread died; ``__cause__`` carries the real crash."""


class Histogram:
    """Recent-window sample metric with nearest-rank percentiles (the
    reference's ``telemetry.registry.Histogram``, reduced to what
    ``stats()`` reads)."""

    def __init__(self, capacity=8192):
        self._cap = int(capacity)
        self._buf = []
        self._next = 0
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def record(self, value):
        v = float(value)
        with self._lock:
            if len(self._buf) < self._cap:
                self._buf.append(v)
            else:
                self._buf[self._next] = v
                self._next = (self._next + 1) % self._cap
            self._count += 1
            self._sum += v

    def percentiles(self, *ps):
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return [None] * len(ps)
        n = len(data)
        return [data[max(int(-(-(p / 100.0 * n) // 1)), 1) - 1] for p in ps]

    @property
    def mean(self):
        return self._sum / self._count if self._count else 0.0


class DecodeStream:
    """Streaming token future for one submitted prompt.

    - ``on_token(token_id)`` fires from the scheduler thread per token;
    - iteration yields generated token ids as they arrive;
    - ``result(timeout)`` blocks until the stream finishes and returns the
      full generated-token list (raises if the request was shed).

    ``expired`` marks a deadline eviction (partial output), ``truncated`` a
    generation clipped by KV capacity.
    """

    def __init__(self, prompt, max_new_tokens, deadline, on_token=None):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline      # absolute perf_counter() time or None
        self.tokens = []
        self.expired = False
        self.truncated = False
        self.t_submit = time.perf_counter()
        self._t_last = None           # engine: last emit time (TTFT/TPOT)
        self._on_token = on_token
        self._cond = threading.Condition()
        self._done = False
        self._error = None

    def _emit(self, tok):
        with self._cond:
            self.tokens.append(tok)
            self._cond.notify_all()
        if self._on_token is not None:
            self._on_token(tok)

    def _finish(self, error=None):
        with self._cond:
            self._error = error
            self._done = True
            self._cond.notify_all()

    @property
    def done(self):
        return self._done

    def result(self, timeout=None):
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise MXNetError("DecodeStream.result timed out")
            if self._error is not None:
                raise self._error
            return list(self.tokens)

    def __iter__(self):
        i = 0
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._done or len(self.tokens) > i)
                if i < len(self.tokens):
                    tok = self.tokens[i]
                else:
                    if self._error is not None:
                        raise self._error
                    return
            i += 1
            yield tok


class DecodeEngine:
    """Continuous-batching autoregressive decoding for a GPT-style model.

    Parameters are the reference's (see ``mxnet_tpu`` for the long form):
    ``num_slots`` (``MXTPU_DECODE_SLOTS``, 8), ``max_len`` (model
    max_length), ``max_prompt_len``, ``prefill_batch``, ``page_tokens``
    (``MXTPU_KV_PAGE_TOKENS``, 128), ``kv_pages`` (``MXTPU_KV_PAGES``, else
    full reservation), ``speculate_k`` (``MXTPU_SPECULATE_K``), ``draft``
    (``MXTPU_DECODE_DRAFT``: ngram | last), ``prefix_cache``
    (``MXTPU_PREFIX_CACHE``, on), ``max_wait_us``
    (``MXTPU_DECODE_MAX_WAIT_US``, 2000), ``deadline_ms``
    (``MXTPU_DECODE_DEADLINE_MS``, 0 = none), ``max_queue``. ``device``:
    where the engine runs; ``None`` means the GPU.

    ``cache_dir``: recorded in the warmup manifest (``False`` or None
    records none); a CUDA graph does not persist, so nothing is read from
    or written to it. ``manifest``: a warmup manifest (path or dict) from
    ``warmup(manifest_path)``; its geometry (slots, lengths, batch, pages,
    speculation, prefix cache) overrides the arguments, and the engine
    warms at construction.
    """

    def __init__(self, model=None, *, num_slots=None, max_len=None,
                 max_prompt_len=None, prefill_batch=4, page_tokens=None,
                 kv_pages=None, speculate_k=None, draft=None,
                 prefix_cache=None, max_wait_us=None, deadline_ms=None,
                 max_queue=None, cache_dir=None, manifest=None,
                 programs=None, tp=None, device=None):
        if programs is not None:
            raise MXNetError(
                "DecodeEngine(programs=...) comes with a later slice of the "
                "PyTorch/CUDA port: programs from an export need the graph "
                "layer")
        if tp is not None and int(tp) != 1:
            raise MXNetError(
                f"DecodeEngine(tp={tp}) comes with a later slice of the "
                "PyTorch/CUDA port (tensor-parallel serving)")
        self.cache_dir = None if cache_dir in (None, False) \
            else str(cache_dir)
        manifest_dict = None
        if manifest is not None:
            manifest_dict = load_decode_manifest(manifest) \
                if isinstance(manifest, str) \
                else _check_manifest(dict(manifest), "the manifest= dict")
            num_slots = int(manifest_dict["num_slots"])
            max_len = int(manifest_dict["max_len"])
            max_prompt_len = int(manifest_dict["max_prompt_len"])
            prefill_batch = int(manifest_dict["prefill_batch"])
            page_tokens = int(manifest_dict["page_tokens"])
            kv_pages = int(manifest_dict["kv_pages"])
            speculate_k = int(manifest_dict["speculate_k"])
            prefix_cache = bool(manifest_dict["prefix_cache"])
        self.device = resolve_device(device)
        if model is None:
            raise MXNetError("DecodeEngine needs a model")
        if model.device != self.device:
            raise MXNetError(
                f"the model lives on {model.device}, the engine on "
                f"{self.device}: move one of them")
        num_slots = int(num_slots or _env_int("MXTPU_DECODE_SLOTS", 8))
        max_len = int(max_len or model.max_length)
        page_tokens = int(page_tokens or
                          _env_int("MXTPU_KV_PAGE_TOKENS", 128))
        if kv_pages is None:
            kv_pages = _env_int("MXTPU_KV_PAGES", 0) or None
        if speculate_k is None:
            speculate_k = _env_int("MXTPU_SPECULATE_K", 0)
        if prefix_cache is None:
            prefix_cache = bool(_env_int("MXTPU_PREFIX_CACHE", 1))
        self.programs = DecodePrograms(
            model, num_slots=num_slots, max_len=max_len,
            prefill_batch=prefill_batch, max_prompt_len=max_prompt_len,
            page_tokens=page_tokens, kv_pages=kv_pages,
            speculate_k=max(1, int(speculate_k)), prefix_cache=prefix_cache)
        self.num_slots = self.programs.num_slots
        self.max_len = self.programs.max_len
        self.max_prompt_len = self.programs.max_prompt_len
        self.prefill_batch = self.programs.prefill_batch
        self.page_tokens = self.programs.page_tokens
        self.kv_pages = self.programs.kv_pages
        self.speculate_k = self.programs.speculate_k
        self.prefix_cache = self.programs.prefix_cache

        self._draft = None
        if self.speculate_k > 1:
            self._draft = make_draft(
                draft or os.environ.get("MXTPU_DECODE_DRAFT") or "ngram")

        self.max_wait_us = int(max_wait_us if max_wait_us is not None
                               else _env_int("MXTPU_DECODE_MAX_WAIT_US",
                                             2000))
        dl = deadline_ms if deadline_ms is not None \
            else _env_int("MXTPU_DECODE_DEADLINE_MS", 0)
        self.deadline_ms = int(dl)
        self.max_queue = int(max_queue if max_queue is not None
                             else max(4 * self.num_slots, 16))

        # -- device + scheduler state (owned by the worker thread) ---------
        self._cache = PagedKVCache(self.programs.cache_shape,
                                   self.programs.cache_dtype,
                                   num_slots=self.num_slots,
                                   max_len=self.max_len, device=self.device)
        self._prefix = RadixPrefixCache(self.page_tokens) \
            if self.prefix_cache else None
        self._slot_req = {}     # sid -> DecodeStream
        self._slot_pages = {}   # sid -> owned pool page ids
        self._slot_handles = {}  # sid -> radix pin handles to release
        self._cols = onp.zeros(self.num_slots, dtype="int32")
        self._last_tok = onp.zeros(self.num_slots, dtype="int32")

        self._q = queue.SimpleQueue()
        self._worker = None
        self._worker_lock = threading.Lock()
        self._closed = False
        self._dead = None        # scheduler crash exception, once fatal
        self._draining = False   # drain(): shed new submits, finish live

        # transient program-run failures retry before the crash path
        self._retries = _env_int("MXTPU_SERVE_RETRIES", 2)
        self._retry_backoff_ms = _env_int("MXTPU_SERVE_RETRY_BACKOFF_MS", 10)
        self._retry_max_ms = _env_int("MXTPU_SERVE_RETRY_MAX_MS", 1000)

        # -- accounting (these ARE the serving stats) -----------------------
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_completed = 0
        self._n_shed = 0
        self._n_evicted = 0
        self._n_tokens = 0
        self._n_ticks = 0
        self._n_prefills = 0
        self._n_prefill_kind = {"prefill": 0, "prefill_ext": 0}
        self._n_starved = 0
        self._n_prefix_hit_tokens = 0
        self._occupancy_sum = 0.0
        self._pending_count = 0
        self._ttft_ms = Histogram()
        self._tpot_ms = Histogram()
        self._spec_accept = Histogram()
        # the registry's metrics, resolved once (the hot sites call inc/set)
        reg = _tm.REGISTRY
        self._m = {n: reg.counter(f"serve.{n}") for n in (
            "requests", "tokens_total", "shed_total", "retries",
            "scheduler_crashes", "prefix_hit_tokens")}
        self._g_slots = reg.gauge("serve.slots_live")
        self._g_kv_bytes = reg.gauge("mem.kv_cache_bytes")
        self._g_pages = reg.gauge("serve.kv_pages_live")

        if manifest_dict is not None:
            self.warmup()

    # ------------------------------------------------------------- warmup
    def warmup(self, manifest_path=None):
        """Build every program bucket (and the CUDA kernels on a GPU):
        on the card, capture each into its CUDA graph and replay it once,
        with page tables that hold only the sentinel, so nothing is written
        and serving captures nothing. Returns the warmup manifest, also
        written (atomically) to ``manifest_path`` when given."""
        self.programs.warmup(self._cache.k, self._cache.v)
        manifest = self.programs.manifest_dict(cache_dir=self.cache_dir)
        if manifest_path:
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh, indent=1)
            os.replace(tmp, manifest_path)
        return manifest

    # ------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens=20, deadline_ms=None,
               on_token=None):
        """Enqueue one prompt; returns a :class:`DecodeStream`.

        Raises :class:`ShedError` immediately when the pending queue is at
        budget. ``deadline_ms`` (engine default when None, 0 = none) bounds
        TOTAL time: a request that can't start in time is shed, one that
        can't finish is evicted with partial output.
        """
        if self._dead is not None:
            raise EngineDeadError(
                f"DecodeEngine scheduler crashed: {self._dead!r}"
            ) from self._dead
        if self._closed:
            raise MXNetError("DecodeEngine is closed")
        if self._draining:
            with self._stats_lock:
                self._n_requests += 1
            self._m["requests"].inc()
            self._shed_one()
            raise ShedError(
                "DecodeEngine is draining: new work is shed until "
                "resume()")
        toks = self._normalize_prompt(prompt)
        if max_new_tokens < 1:
            raise MXNetError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        with self._stats_lock:
            self._n_requests += 1
            over = self._pending_count >= self.max_queue
            if not over:
                self._pending_count += 1
        self._m["requests"].inc()
        if over:
            self._shed_one()
            raise ShedError(
                f"decode queue at budget ({self.max_queue} pending); "
                "retry later or raise max_queue")
        dl_ms = self.deadline_ms if deadline_ms is None else int(deadline_ms)
        deadline = (time.perf_counter() + dl_ms * 1e-3) if dl_ms > 0 else None
        # clip generation to cache capacity: the last token's KV lands at
        # position len(prompt) + max_new - 2, which must stay < max_len
        budget = self.max_len - len(toks) + 1
        stream = DecodeStream(toks, min(int(max_new_tokens), budget),
                              deadline, on_token)
        if stream.max_new_tokens < max_new_tokens:
            stream.truncated = True
        self._start_worker()
        self._q.put(stream)
        return stream

    def _normalize_prompt(self, prompt):
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.cpu().numpy()
        toks = [int(t) for t in onp.asarray(prompt).reshape(-1)]
        if not toks:
            raise MXNetError("cannot decode from an empty prompt")
        if len(toks) > self.max_prompt_len:
            raise MXNetError(
                f"prompt length {len(toks)} exceeds max_prompt_len "
                f"{self.max_prompt_len}")
        return toks

    # ---------------------------------------------------------- scheduler
    def _start_worker(self):
        if self._worker is not None:
            return
        with self._worker_lock:
            if self._worker is None:
                t = threading.Thread(target=self._loop,
                                     name="mxtt-decode-engine", daemon=True)
                self._worker = t
                t.start()

    def _loop(self):
        pending = deque()
        crash = None
        try:
            # grad mode and the current CUDA device are thread-local: set
            # them in the worker itself
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                while not self._gather(pending):
                    self._expire(pending)
                    self._admit(pending)
                    if self._slot_req:
                        self._tick()
        except BaseException as e:  # noqa: BLE001 — converted, never lost
            crash = e
        finally:
            if crash is not None:
                self._scheduler_crashed(crash, pending)
            else:
                self._drain(pending)

    def _scheduler_crashed(self, exc, pending):
        """Fatal scheduler error: mark dead, fail every stream with the
        real cause."""
        self._dead = exc
        self._closed = True
        self._m["scheduler_crashes"].inc()
        err = EngineDeadError(f"DecodeEngine scheduler crashed: {exc!r}")
        err.__cause__ = exc
        self._drain(pending, err=err)

    def _run_retry(self, key, args, point):
        """One program run behind the transient-failure retry policy: up to
        ``MXTPU_SERVE_RETRIES`` retries with exponential backoff capped at
        ``MXTPU_SERVE_RETRY_MAX_MS``; ``point`` is also a chaos injection
        site. A device out-of-memory error is not transient and is not
        retried; exhaustion re-raises into the crash path."""
        attempt = 0
        while True:
            try:
                chaos.fault_point(point)
                return self.programs.run(key, args)
            except torch.cuda.OutOfMemoryError:
                raise
            except Exception:   # noqa: BLE001 — bounded retries
                if attempt >= self._retries:
                    raise
                attempt += 1
                self._m["retries"].inc()
                delay_ms = min(self._retry_backoff_ms * (1 << (attempt - 1)),
                               self._retry_max_ms)
                time.sleep(delay_ms * 1e-3)

    def _gather(self, pending):
        """Pull new requests off the queue. Blocks when fully idle;
        otherwise drains without waiting. Returns True on STOP."""
        idle = not self._slot_req and not pending
        try:
            item = self._q.get() if idle else self._q.get_nowait()
        except queue.Empty:
            return False
        if item is _STOP:
            return True
        pending.append(item)
        if idle and self.max_wait_us > 0:
            # a burst is likely arriving together: hold the first prefill
            # open briefly so it batches instead of running B=1
            deadline = time.perf_counter() + self.max_wait_us * 1e-6
            while len(pending) < self.prefill_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is _STOP:
                    return True
                pending.append(item)
        else:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    return True
                pending.append(item)
        return False

    def _expire(self, pending):
        now = time.perf_counter()
        for stream in [s for s in pending
                       if s.deadline is not None and now > s.deadline]:
            pending.remove(stream)
            self._shed_one(admitted=True)
            stream._finish(ShedError(
                "deadline expired before the request reached a slot"))
        for sid in [s for s, st in self._slot_req.items()
                    if st.deadline is not None and now > st.deadline]:
            self._retire(sid, expired=True)

    # ------------------------------------------------------ page admission
    def _alloc_pages(self, n):
        """Claim n pool pages, evicting unpinned prefix-cache pages LRU
        first when the free list is short. None when impossible now."""
        if n == 0:
            return []
        cache = self._cache
        got = cache.pages.alloc(n)
        if got is not None:
            return got
        if self._prefix is not None:
            freed = self._prefix.evict(n - cache.pages.free_count)
            if freed:
                cache.pages.free(freed)
                got = cache.pages.alloc(n)
        return got

    def _prepare(self, stream):
        """Prefix lookup + page allocation for one pending stream; None
        when pages are short."""
        P = self.page_tokens
        plen = len(stream.prompt)
        if self._prefix is not None:
            matched, shared, handle = self._prefix.match(stream.prompt)
        else:
            matched, shared, handle = 0, [], None
        need = -(-plen // P) - len(shared)
        own = self._alloc_pages(need)
        if own is None:
            if handle:
                self._prefix.release(handle)
            return None
        return {"start": matched, "shared": shared, "own": own,
                "handle": handle}

    def _admit(self, pending):
        cache = self._cache
        while pending and cache.slots.free_count:
            group, metas = [], []
            while (pending and len(group) < self.prefill_batch
                   and len(group) < cache.slots.free_count):
                meta = self._prepare(pending[0])
                if meta is None:
                    if group or self._slot_req or (
                            self._prefix is not None
                            and self._prefix.evictable_pages() > 0):
                        break   # pages will free up: try again next tick
                    # nothing live, nothing evictable: this prompt can
                    # never fit — shed it instead of spinning forever
                    stream = pending.popleft()
                    self._shed_one(admitted=True)
                    stream._finish(ShedError(
                        f"kv page pool exhausted: prompt needs "
                        f"{-(-len(stream.prompt) // self.page_tokens)} "
                        f"pages, pool has {cache.pages.free_count} free "
                        f"of {self.kv_pages}"))
                    continue
                group.append(pending.popleft())
                metas.append(meta)
            if not group:
                break
            # plain and join prefills are separate program families
            plain = [(s, m) for s, m in zip(group, metas)
                     if m["start"] == 0]
            ext = [(s, m) for s, m in zip(group, metas) if m["start"] > 0]
            for sub in (plain, ext):
                if not sub:
                    continue
                try:
                    self._prefill(sub)
                except BaseException:
                    # hand the subgroup back so the crash path fails these
                    # streams with the real error
                    pending.extendleft(s for s, _ in reversed(sub))
                    raise

    def _prefill(self, sub):
        cache = self._cache
        P = self.page_tokens
        ext = sub[0][1]["start"] > 0
        slots = [cache.slots.alloc() for _ in sub]
        B = pick_bucket(len(sub), self.programs.batch_ladder)
        T = pick_bucket(max(len(s.prompt) - m["start"] for s, m in sub),
                        self.programs.len_ladder)
        tokens = onp.zeros((B, T), dtype="int32")
        valid = onp.ones((B,), dtype="int32")
        start = onp.zeros((B,), dtype="int32")
        table = onp.full((B, cache.pages_per_slot + 1), cache.trash,
                         dtype="int32")
        for i, ((stream, meta), sid) in enumerate(zip(sub, slots)):
            row = meta["shared"] + meta["own"]
            cache.table[sid, :] = cache.trash
            cache.table[sid, :len(row)] = row
            self._cols[sid] = len(row)
            self._slot_pages[sid] = list(meta["own"])
            self._slot_handles[sid] = [meta["handle"]] if meta["handle"] \
                else []
            suffix = stream.prompt[meta["start"]:]
            tokens[i, :len(suffix)] = suffix
            valid[i] = len(suffix)
            start[i] = meta["start"]
            table[i] = cache.table[sid]
        kind = "prefill_ext" if ext else "prefill"
        key = (kind, B, T)
        self.programs.ensure(kind, batch=B, length=T)
        args = [tokens, valid] + ([start] if ext else []) + \
            [table, cache.k, cache.v]
        outs = self._run_retry(key, args, point="decode.prefill")
        cache.rebind(outs[1], outs[2])
        first = outs[0].cpu().numpy()   # device sync: the TTFT tokens
        with self._stats_lock:
            self._n_prefills += 1
            self._n_prefill_kind[kind] += 1
            self._pending_count -= len(sub)
        for i, ((stream, meta), sid) in enumerate(zip(sub, slots)):
            plen = len(stream.prompt)
            cache.lengths[sid] = plen
            self._slot_req[sid] = stream
            if meta["start"]:
                with self._stats_lock:
                    self._n_prefix_hit_tokens += meta["start"]
                self._m["prefix_hit_tokens"].inc(meta["start"])
            if self._prefix is not None:
                # publish this prompt's full pages for future sharers;
                # adopted pages change owner (the tree frees them, not us)
                a0 = meta["start"] // P
                full = plen // P - a0
                offered = {a0 + t: meta["own"][t] for t in range(full)}
                handle, adopted = self._prefix.insert(stream.prompt,
                                                      offered)
                if handle:
                    self._slot_handles[sid].append(handle)
                if adopted:
                    keep = [pid for t, pid in enumerate(meta["own"])
                            if (a0 + t) not in adopted]
                    self._slot_pages[sid] = keep
            tok = int(first[i])
            self._last_tok[sid] = tok
            self._emit_tokens(stream, [tok])
            if len(stream.tokens) >= stream.max_new_tokens:
                self._retire(sid)
        self._set_slot_gauge()

    def _tick(self):
        cache = self._cache
        P = self.page_tokens
        K = self.speculate_k
        W = cache.pages_per_slot
        live = sorted(self._slot_req)
        # grow page tables to cover this tick's K write positions; a slot
        # the pool can't serve is starved: it commits at most one more
        # token and retires truncated (shed capacity, never crash)
        starved = set()
        for sid in live:
            need = min(-(-(int(cache.lengths[sid]) + K) // P), W)
            short = need - int(self._cols[sid])
            if short > 0:
                got = self._alloc_pages(short)
                if got is None:
                    starved.add(sid)
                else:
                    c = int(self._cols[sid])
                    cache.table[sid, c:c + len(got)] = got
                    self._cols[sid] = c + len(got)
                    self._slot_pages[sid].extend(got)
        tokens = onp.zeros((self.num_slots, K), dtype="int32")
        tokens[:, 0] = self._last_tok
        drafts = {}
        if K > 1:
            for sid in live:
                stream = self._slot_req[sid]
                d = self._draft.propose(stream.prompt + stream.tokens,
                                        K - 1)
                drafts[sid] = d
                tokens[sid, 1:] = d
        key = ("decode", K)
        self.programs.ensure("decode")
        outs = self._run_retry(key, [tokens, cache.lengths, cache.table,
                                     cache.k, cache.v], point="decode.tick")
        cache.rebind(outs[1], outs[2])
        rows = outs[0].cpu().numpy()   # device sync: this tick's tokens
        occ = cache.occupancy()
        with self._stats_lock:
            self._n_ticks += 1
            self._occupancy_sum += occ
        for sid in live:
            stream = self._slot_req[sid]
            m = accept_longest_prefix(drafts[sid], rows[sid]) if K > 1 \
                else 1
            if K > 1:
                self._spec_accept.record(m)
            ln = int(cache.lengths[sid])
            m = min(m, stream.max_new_tokens - len(stream.tokens),
                    cache.max_len - ln)
            if sid in starved:
                m = min(m, 1)
            toks = [int(t) for t in rows[sid][:m]]
            cache.lengths[sid] = ln + m
            self._last_tok[sid] = toks[-1]
            self._emit_tokens(stream, toks)
            if len(stream.tokens) >= stream.max_new_tokens:
                self._retire(sid)
            elif cache.lengths[sid] >= cache.max_len or sid in starved:
                stream.truncated = True
                if sid in starved:
                    with self._stats_lock:
                        self._n_starved += 1
                self._retire(sid)

    def _emit_tokens(self, stream, toks):
        """Emit a committed token run. The first token ever is TTFT; a
        multi-token (speculative) commit spreads the tick's wall time
        evenly across its tokens for TPOT."""
        if not toks:
            return
        now = time.perf_counter()
        n = len(toks)
        i0 = 0
        if stream._t_last is None:
            self._ttft_ms.record((now - stream.t_submit) * 1e3)
            i0 = 1
        if n - i0 > 0:
            ms = (now - stream._t_last) * 1e3 / (n - i0) \
                if stream._t_last is not None else 0.0
            for _ in range(n - i0):
                self._tpot_ms.record(ms)
        stream._t_last = now
        with self._stats_lock:
            self._n_tokens += n
        self._m["tokens_total"].inc(n)
        for tok in toks:
            stream._emit(tok)

    def _retire(self, sid, expired=False):
        cache = self._cache
        stream = self._slot_req.pop(sid)
        cache.slots.free(sid)
        cache.reset_row(sid)
        self._cols[sid] = 0
        owned = self._slot_pages.pop(sid, [])
        if owned:
            cache.pages.free(owned)
        for handle in self._slot_handles.pop(sid, []):
            self._prefix.release(handle)
        self._last_tok[sid] = 0
        stream.expired = expired
        stream._finish()
        with self._stats_lock:
            self._n_completed += 1
            if expired:
                self._n_evicted += 1
        self._set_slot_gauge()

    def _shed_one(self, admitted=False):
        with self._stats_lock:
            self._n_shed += 1
            if admitted:
                self._pending_count -= 1
        self._m["shed_total"].inc()

    def _set_slot_gauge(self):
        self._g_slots.set(len(self._slot_req))
        # KV residency: the pool's bytes are static per engine; pages_live
        # tracks the tokens resident in it
        self._g_kv_bytes.set(self._cache.nbytes)
        self._g_pages.set(self._cache.pages_live())

    def _drain(self, pending, err=None):
        if err is None:
            err = MXNetError("DecodeEngine closed before completion")
        for sid in list(self._slot_req):
            stream = self._slot_req.pop(sid)
            self._cache.slots.free(sid)
            stream._finish(err)
        for stream in pending:
            self._shed_one(admitted=True)
            stream._finish(err)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._shed_one(admitted=True)
                item._finish(err)

    # ----------------------------------------------------------- reporting
    def stats(self):
        """Engine accounting: requests, tokens, ticks, prefills (by
        family), prefix hits, TTFT/TPOT percentiles, occupancy."""
        with self._stats_lock:
            ticks = self._n_ticks
            occ = self._occupancy_sum / ticks if ticks else 0.0
            out = {
                "requests": self._n_requests,
                "completed": self._n_completed,
                "shed": self._n_shed,
                "evicted": self._n_evicted,
                "tokens": self._n_tokens,
                "ticks": ticks,
                "prefills": self._n_prefills,
                "prefills_by_kind": dict(self._n_prefill_kind),
                "pending": self._pending_count,
                "prefix_hit_tokens": self._n_prefix_hit_tokens,
                "page_starved": self._n_starved,
            }
        p50, p99 = self._ttft_ms.percentiles(50, 99)
        out["ttft_ms_p50"], out["ttft_ms_p99"] = p50, p99
        p50, p99 = self._tpot_ms.percentiles(50, 99)
        out["tpot_ms_p50"], out["tpot_ms_p99"] = p50, p99
        out["mean_slot_occupancy"] = occ
        out["slots_live"] = len(self._slot_req)
        out["num_slots"] = self.num_slots
        out["cache_bytes"] = self._cache.nbytes
        out["page_tokens"] = self.page_tokens
        out["kv_pages"] = self.kv_pages
        out["kv_pages_live"] = self._cache.pages_live()
        out["speculate_k"] = self.speculate_k
        if self.speculate_k > 1:
            out["spec_accept_mean"] = self._spec_accept.mean
            out["tokens_per_tick"] = (out["tokens"] / ticks) if ticks \
                else 0.0
        out["prefix_cache"] = self._prefix.stats() \
            if self._prefix is not None else None
        out["dead"] = self._dead is not None
        out["draining"] = self._draining
        out["programs"] = sorted(
            "|".join(str(k) for k in key)
            for key in self.programs._programs)
        return out

    # -------------------------------------------------------------- health
    def _health(self):
        if self._dead is not None:
            return False, f"scheduler crashed: {self._dead!r}"
        return True, {"slots_live": len(self._slot_req),
                      "draining": self._draining}

    @property
    def healthy(self):
        return self._dead is None

    # ---------------------------------------------------------- drain/resume
    def drain(self, timeout=None):
        """Shed new submissions (``ShedError``) while already-accepted work
        — live slots and queued requests not yet in a slot — runs to
        completion. Blocks until idle (or ``timeout`` seconds); returns True
        when fully drained. ``resume()`` reopens the gate."""
        self._draining = True
        deadline = None if timeout is None \
            else time.perf_counter() + float(timeout)
        while True:
            with self._stats_lock:
                pending = self._pending_count
            if not self._slot_req and pending <= 0:
                return True
            if self._dead is not None or self._closed:
                return not self._slot_req
            if deadline is not None and time.perf_counter() > deadline:
                return False
            time.sleep(0.002)

    def resume(self):
        """Accept submissions again after :meth:`drain`."""
        self._draining = False

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Stop the scheduler (idempotent). Live and queued streams finish
        with an error; later ``submit`` raises."""
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
