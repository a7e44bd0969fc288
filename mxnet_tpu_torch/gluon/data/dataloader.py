"""DataLoader: batched, shuffled, prefetching input pipeline.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference:
python/mxnet/gluon/data/dataloader.py — fork-based worker processes with
shared-memory NDArray pickling, dataloader.py:67-138, kCPUShared storage).
The three worker models of the JAX package:

- ``num_workers=0``: the caller's thread loads each batch;
- ``thread_pool=True``: thread workers feeding a bounded reorder buffer
  (NumPy releases the GIL for the hot loops) — light startup, right for
  cheap per-sample work;
- ``num_workers>0`` (default): SPAWNED worker processes, never forked (CUDA
  cannot be initialised again in a forked child). Each starts with
  ``CUDA_VISIBLE_DEVICES=""`` in its environment and makes the host its
  device (``context.spawn_cpu_pinned_env``, ``pin_process_to_cpu``), so no
  worker creates a CUDA context or builds a kernel. Batches travel back
  through POSIX shared memory (``multiprocessing.shared_memory``, the
  analog of the reference's kCPUShared storage), routed by (epoch, batch)
  so that concurrent iterators over one loader each get their own.

Workers stack samples on the host (numpy). The loader's iterator then moves
each batch to the device of the context current where ``iter(loader)`` was
called (on the card unless that caller is inside ``with mx.cpu():``), on
the thread and CUDA stream that consume it, and yields NDArrays there, with
64-bit arrays narrowed to 32 bits as the reference's x64-off arrays are.
The context is resolved once, on the caller's thread, and handed to the
workers: a context scope is per thread, and a batchify function or dataset
that makes NDArrays in a thread worker makes them on the caller's device.

``pin_memory=True`` is honoured on the card: each batch is staged in
page-locked host memory and copied with ``non_blocking=True`` on the
consuming stream (the reference accepts the flag and ignores it). Every
batch's wait is recorded in the port's telemetry registry, always on: the
``dataloader.batch`` timer and the ``dataloader.batches`` counter.
"""
from __future__ import annotations

import pickle
import queue
import threading
import time

import numpy as onp
import torch

from ... import telemetry as _tm
from ...base import MXNetError, narrow
from ...context import current_context
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_mp_batchify_fn(data):
    """Worker-side batchify: stack into HOST numpy (no device work in the
    worker — arrays ship to the parent through shared memory)."""
    if isinstance(data[0], NDArray):
        return onp.stack([d.asnumpy() for d in data])
    if isinstance(data[0], (tuple, list)):
        return tuple(default_mp_batchify_fn(list(d)) for d in zip(*data))
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return arr


def _wrap_nd(obj):
    if isinstance(obj, onp.ndarray):
        return NDArray(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_wrap_nd(o) for o in obj)
    return obj


def default_batchify_fn(data):
    """Stack samples into a batch of NDArrays on the current context
    (reference: dataloader default_batchify_fn) — the numpy batchify with
    NDArray-wrapped leaves."""
    return _wrap_nd(default_mp_batchify_fn(data))


# ---------------------------------------------------------------------------
# landing batches on the device
# ---------------------------------------------------------------------------
def host_tensor(a):
    """A CPU tensor of host array ``a`` (a view where the dtype allows),
    64-bit types narrowed to 32 bits; numpy bfloat16 becomes torch's."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(onp.float32)).to(torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    return narrow(torch.from_numpy(onp.ascontiguousarray(a)))


def to_device(t, dev, pin):
    """Tensor ``t`` on ``dev``: a host tensor goes through page-locked
    memory with a ``non_blocking`` copy on the current stream when ``pin``
    and ``dev`` is a GPU, else by a plain copy; one already there as it
    is."""
    if t.device == dev:
        return t
    if pin and dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _land(obj, dev, pin):
    """The batch ``obj`` with every array leaf an NDArray on ``dev``."""
    if isinstance(obj, NDArray):
        t = obj._data
    elif isinstance(obj, torch.Tensor):
        t = obj
    elif isinstance(obj, onp.ndarray):
        t = host_tensor(obj)
    elif isinstance(obj, (tuple, list)):
        return type(obj)(_land(o, dev, pin) for o in obj)
    else:
        return obj
    return NDArray(to_device(t, dev, pin))


# ---------------------------------------------------------------------------
# process workers: spawn + shared-memory transport
# ---------------------------------------------------------------------------
def _to_shm(obj, segments):
    """Replace numpy arrays in a nested batch with shared-memory handles."""
    if isinstance(obj, torch.Tensor):
        obj = NDArray(obj)
    if isinstance(obj, NDArray):
        obj = obj.asnumpy()
    if isinstance(obj, onp.ndarray):
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(create=True,
                                         size=max(obj.nbytes, 1))
        view = onp.ndarray(obj.shape, obj.dtype, buffer=shm.buf)
        view[...] = obj
        del view
        segments.append(shm)
        return ("__shm__", shm.name, obj.shape, str(obj.dtype))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_shm(o, segments) for o in obj)
    return obj


def _from_shm(obj, opened, dev, pin):
    """Parent side: map shared segments and land the batch on ``dev``. The
    result holds no view of a segment (each is copied out: to the device,
    to page-locked memory first when ``pin``, or to an owned host
    tensor), so the caller may unlink the segments at once."""
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        from multiprocessing import shared_memory

        _, name, shape, dtype = obj
        shm = shared_memory.SharedMemory(name=name)
        opened.append(shm)
        host = host_tensor(onp.ndarray(shape, onp.dtype(dtype),
                                       buffer=shm.buf))
        if dev.type == "cpu":
            return NDArray(host.clone())
        return NDArray(to_device(host, dev, pin))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_from_shm(o, opened, dev, pin) for o in obj)
    return obj


def _unlink_payload(obj):
    """Free shared segments of a payload that will never be consumed."""
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=obj[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
        return
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _unlink_payload(o)


def _shutdown_pool(task_q, result_q, procs, init_q):
    """Finalizer: stop workers and free any undelivered shared segments."""
    for _ in procs:
        try:
            task_q.put_nowait(None)
        except Exception:  # noqa: BLE001
            pass
    for p in procs:
        p.join(timeout=2.0)
        if p.is_alive():
            p.terminate()
    while True:
        try:
            _key, payload, _err = result_q.get_nowait()
        except Exception:  # noqa: BLE001 — drained
            break
        _unlink_payload(payload)


def _worker_loop(init_q, task_q, result_q):
    """Spawned worker entry: the host is its device and no GPU is visible
    to it, before the dataset is unpickled. The pickled dataset and
    batchify function come through ``init_q``, not as the process's
    arguments: ``Process.start()`` writes its arguments into a pipe that the
    child drains only after importing torch, so a dataset larger than the
    pipe's buffer would hold each ``start()`` for the previous worker's
    imports, and the pool would start one worker at a time."""
    from ...context import pin_process_to_cpu

    pin_process_to_cpu()
    dataset_pkl, batchify_pkl = init_q.get()
    dataset = pickle.loads(dataset_pkl)
    batchify = pickle.loads(batchify_pkl)
    while True:
        task = task_q.get()
        if task is None:
            return
        bid, indices = task
        segments = []
        try:
            batch = batchify([dataset[i] for i in indices])
            payload = _to_shm(batch, segments)
        except BaseException as e:  # noqa: BLE001 — report, don't die silent
            # the parent gets no payload, so segments created before the
            # failure must be unlinked HERE or they leak until exit
            for shm in segments:
                shm.close()
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
            result_q.put((bid, None, f"{type(e).__name__}: {e}"))
        else:
            result_q.put((bid, payload, None))
            for shm in segments:
                shm.close()  # parent owns unlinking


class DataLoader:
    """Batched loader over a Dataset; see the module docstring for the
    worker models, where batches land and ``pin_memory``."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle and sampler are mutually exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._thread_pool = thread_pool
        self._num_workers = max(0, num_workers)
        self._pin = bool(pin_memory)
        # every worker model stacks on the host; _land moves the batch
        self._batchify_fn = batchify_fn or default_mp_batchify_fn
        self._prefetch = max(1, prefetch if prefetch is not None
                             else 2 * max(1, self._num_workers))
        self._pool = None
        self._epoch = 0
        self._live_epochs: set[int] = set()
        self._stray: dict[int, dict] = {}

    def __len__(self):
        return len(self._batch_sampler)

    def device_prefetch(self, multi_step=None, depth=None, sharding=None):
        """Wrap this loader in a :class:`DevicePrefetcher`: stack groups
        of ``multi_step`` batches into the ``[K, batch, ...]`` super-
        batches the compiled multi-step consumes and stage them on a CUDA
        stream of their own while the previous group computes."""
        from .prefetcher import DevicePrefetcher

        return DevicePrefetcher(self, multi_step=multi_step, depth=depth,
                                sharding=sharding)

    def _load_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        ctx = current_context()
        return self._iter(ctx, ctx.torch_device)

    def _iter_impl(self, ctx, dev):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                with ctx:
                    batch = self._load_batch(indices)
                yield _land(batch, dev, self._pin)
        elif self._thread_pool:
            yield from self._threaded_iter(ctx, dev)
        else:
            yield from self._process_iter(dev)

    def _iter(self, ctx, dev):
        """Time how long the consumer waits for each batch (prefetch-hit
        ~ 0; a large wait means the input pipeline, not the card, is the
        bottleneck)."""
        t = _tm.timer("dataloader.batch")
        n = _tm.counter("dataloader.batches")
        inner = self._iter_impl(ctx, dev)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(inner)
                except StopIteration:
                    return
                t.record(time.perf_counter() - t0)
                n.inc()
                yield batch
        finally:
            inner.close()

    def _ensure_pool(self):
        """Spawn the persistent worker pool once; reused across epochs (the
        spawn + import cost is paid on the first iteration only, like the
        reference's long-lived fork pool)."""
        if self._pool is not None:
            return self._pool
        import multiprocessing as mp
        import weakref

        from ...context import spawn_cpu_pinned_env

        ctx = mp.get_context("spawn")
        try:
            dataset_pkl = pickle.dumps(self._dataset)
            batchify_pkl = pickle.dumps(self._batchify_fn)
        except Exception as e:  # noqa: BLE001
            raise MXNetError(
                "DataLoader(num_workers>0): dataset/batchify_fn must be "
                f"picklable for spawned workers ({e}); pass "
                "thread_pool=True to use thread workers instead") from e
        init_q = ctx.Queue()
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        procs = [ctx.Process(target=_worker_loop,
                             args=(init_q, task_q, result_q), daemon=True)
                 for _ in range(self._num_workers)]
        for _ in procs:
            init_q.put((dataset_pkl, batchify_pkl))
        # a copy no worker took (one died starting) must not hold up exit
        init_q.cancel_join_thread()
        # children take the environment at exec time: no GPU is visible to
        # them from their first instruction, including while they
        # re-import the parent's __main__
        with spawn_cpu_pinned_env():
            for p in procs:
                p.start()
        # the pool holds init_q too: a queue collected before every child
        # has unpickled it takes its semaphores' names with it
        self._pool = (task_q, result_q, procs, init_q)
        weakref.finalize(self, _shutdown_pool, task_q, result_q, procs,
                         init_q)
        return self._pool

    def _process_iter(self, dev):
        """Persistent spawned workers + shared-memory batch transport.

        Concurrent iterators over one loader share the result queue, so
        each result is routed by its (epoch, batch) key: live epochs'
        batches are stashed for their iterator (``self._stray``); results
        for epochs no longer in ``self._live_epochs`` are unlinked.
        """
        task_q, result_q, procs, _ = self._ensure_pool()
        epoch = self._epoch
        self._epoch += 1
        self._live_epochs.add(epoch)
        batches = list(self._batch_sampler)
        reorder: dict[int, object] = {}

        def route(key, payload, err):
            ep, bid = key
            if ep == epoch:
                if err is not None:
                    raise MXNetError(f"DataLoader worker failed: {err}")
                reorder[bid] = payload
            elif ep in self._live_epochs:
                self._stray.setdefault(ep, {})[bid] = (payload, err)
            else:
                _unlink_payload(payload)

        try:
            for sent in range(min(self._prefetch, len(batches))):
                task_q.put(((epoch, sent), batches[sent]))
            sent = min(self._prefetch, len(batches))
            for want in range(len(batches)):
                mine = self._stray.get(epoch)
                while mine and want not in reorder:
                    bid, (payload, err) = mine.popitem()
                    if err is not None:
                        raise MXNetError(f"DataLoader worker failed: {err}")
                    reorder[bid] = payload
                while want not in reorder:
                    try:
                        key, payload, err = result_q.get(
                            timeout=self._timeout)
                    except queue.Empty:
                        raise MXNetError(
                            f"DataLoader worker timeout ({self._timeout}s); "
                            "a worker may have died — check stderr") \
                            from None
                    route(key, payload, err)
                if sent < len(batches):
                    task_q.put(((epoch, sent), batches[sent]))
                    sent += 1
                opened = []
                try:
                    batch = _from_shm(reorder.pop(want), opened, dev,
                                      self._pin)
                finally:
                    for shm in opened:
                        shm.close()
                        try:
                            shm.unlink()
                        except FileNotFoundError:
                            pass
                yield batch
        finally:
            # early exit (break / error): free undelivered batches; results
            # still in flight are unlinked by whichever iterator drains
            # them (this epoch is dead now) or by pool shutdown
            self._live_epochs.discard(epoch)
            for payload in reorder.values():
                _unlink_payload(payload)
            for payload, _err in self._stray.pop(epoch, {}).values():
                _unlink_payload(payload)

    def _threaded_iter(self, ctx, dev):
        batches = list(self._batch_sampler)
        out_q: dict[int, object] = {}
        done = threading.Event()
        lock = threading.Condition()
        idx_iter = iter(enumerate(batches))
        idx_lock = threading.Lock()
        error: list[BaseException] = []

        def worker():
            while not done.is_set():
                with idx_lock:
                    try:
                        i, indices = next(idx_iter)
                    except StopIteration:
                        return
                try:
                    with ctx:
                        batch = self._load_batch(indices)
                except BaseException as e:  # noqa: BLE001
                    with lock:
                        error.append(e)
                        lock.notify_all()
                    return
                with lock:
                    while (len(out_q) >= self._prefetch and
                           min(out_q, default=i) < i and not done.is_set()):
                        lock.wait(0.1)
                    out_q[i] = batch
                    lock.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with lock:
                    deadline = self._timeout
                    while i not in out_q and not error:
                        if not lock.wait(0.5):
                            deadline -= 0.5
                            if deadline <= 0:
                                raise MXNetError("DataLoader worker timeout")
                    if error:
                        raise error[0]
                    batch = out_q.pop(i)
                    lock.notify_all()
                yield _land(batch, dev, self._pin)
        finally:
            done.set()
            for t in threads:
                t.join(timeout=1.0)
