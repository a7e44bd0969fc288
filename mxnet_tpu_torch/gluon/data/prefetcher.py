"""DevicePrefetcher: staging groups of batches on the device ahead of the
compiled step.

Counterpart of ``mxnet_tpu/gluon/data/prefetcher.py``. A worker thread
pulls batches from any batch source (a ``DataLoader``, an ``io.DataIter``,
a list), stacks groups of ``multi_step=K`` of them into the ``[K, batch,
...]`` super-batches that ``compile_multi_step(K)`` consumes, and stages
each group on the device while the previous group computes.

On the card the worker thread runs on a CUDA stream of its own: the
source's host-to-device copies (a ``DataLoader`` lands its batches on the
thread and stream that consume them, from page-locked memory with
``pin_memory=True``) and the stacking go there, and an event is recorded
after them. ``__next__`` makes the consumer's current stream wait on that
event and marks the staged tensors as used on it (``record_stream``), so a
step that copies the group into its static buffers never reads a half
staged group and the allocator never hands the memory to the next group
while the step still reads it. A batch already on the device stays a
tensor: it is stacked there, never taken through the host.

The context current where the epoch starts (the first ``next``, on the
consumer's thread) is the device staged to, and the worker thread enters
it: a context scope is per thread, so a source that makes NDArrays there
makes them on the consumer's device.

Checkpoint position contract: ``state_dict()`` reports batches CONSUMED
(yielded to the training loop), never batches the worker has merely
staged — a resume replays exactly the batches whose updates were not
committed.

A shorter trailing group at epoch end is staged with its natural leading
extent; a batch of another shape closes the open group early, so every
stack stays rectangular.

Fault injection: the worker declares ``chaos.fault_point("prefetch.stage")``
per staged group; an armed fault surfaces on the consumer as a clean
``MXNetError`` for the epoch instead of a hung queue.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as onp
import torch

from ...base import MXNetError, warn_once
from ...context import current_context
from ...ndarray.ndarray import NDArray
from .dataloader import host_tensor, to_device

__all__ = ["DevicePrefetcher"]

_POLL_S = 0.1  # consumer/producer wakeup granularity (stop + death checks)


def _leaves(batch):
    """One source batch as a tuple of tensors, each where it lies."""
    from ...io import DataBatch

    if isinstance(batch, DataBatch):
        parts = list(batch.data) + list(batch.label)
    elif isinstance(batch, (tuple, list)):
        parts = list(batch)
    else:
        parts = [batch]
    return tuple(p._data if isinstance(p, NDArray) else
                 p if isinstance(p, torch.Tensor) else
                 host_tensor(onp.asarray(p)) for p in parts)


class DevicePrefetcher:
    """Stack + stage batches on device ahead of the training loop.

    Parameters
    ----------
    source : iterable of batches
        Re-iterable batch source: ``DataLoader``, ``io.DataIter`` (its
        ``reset()`` is called at each epoch start), list of batches, ...
    multi_step : int or None
        Group size K: yield ``[K, batch, ...]``-stacked device arrays for
        ``compile_multi_step(K)``. ``None`` stages single batches.
    depth : int or None
        Staging queue depth (groups in flight). Default
        ``MXTPU_PREFETCH_DEPTH`` or 2 — one group computing, one staged.
    sharding : None
        The reference's ``jax.device_put`` sharding; not ported (one
        device; ROADMAP A8): anything but None raises.
    timeout : float
        Seconds the consumer waits on the staging queue before declaring
        the worker wedged (clean error, never a silent hang).
    """

    def __init__(self, source, multi_step=None, depth=None, sharding=None,
                 timeout=60.0):
        if sharding is not None:
            raise MXNetError("DevicePrefetcher(sharding=...) is not ported: "
                             "the port stages to one device (ROADMAP A8)")
        if multi_step is not None:
            multi_step = int(multi_step)
            if multi_step < 1:
                raise MXNetError(
                    f"multi_step must be >= 1, got {multi_step}")
        if depth is None:
            depth = int(os.environ.get("MXTPU_PREFETCH_DEPTH", "2"))
        if depth < 1:
            raise MXNetError(f"prefetch depth must be >= 1, got {depth}")
        if hasattr(source, "state_dict"):
            warn_once(("device_prefetch_order", id(source)),
                      "DevicePrefetcher wraps a position-tracking source: "
                      "its counter will see STAGED batches, not consumed "
                      "ones. Keep the position on the prefetcher "
                      "(its state_dict) instead", RuntimeWarning)
        self._source = source
        self._k = multi_step
        self._depth = depth
        self._timeout = float(timeout)
        self.epoch = 0
        self.offset = 0          # SOURCE batches consumed this epoch
        self._pending_skip = 0   # resume fast-forward, applied at epoch start
        self._q = None
        self._stop = threading.Event()
        self._worker_t = None
        self._dev = None
        self._stream = None      # the staging stream, on the card

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._worker_t is None:
            self._start_epoch()
        waited = 0.0
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                if not self._worker_t.is_alive():
                    # died without reporting (e.g. killed mid-stage):
                    # fail the epoch instead of hanging the step's feed
                    self._worker_t = None
                    raise MXNetError(
                        "DevicePrefetcher worker died without staging a "
                        "batch or closing the epoch")
                waited += _POLL_S
                if waited >= self._timeout:
                    raise MXNetError(
                        f"DevicePrefetcher stalled: no batch staged in "
                        f"{self._timeout:.0f}s (source wedged?)")
        tag = item[0]
        if tag == "batch":
            _, arrays, n_src, staged = item
            if staged is not None:
                cur = torch.cuda.current_stream(self._dev)
                cur.wait_event(staged)
                for t in arrays:
                    t.record_stream(cur)
            self.offset += n_src
            return tuple(NDArray(t) for t in arrays)
        self._join_worker()
        if tag == "end":
            self.epoch += 1
            self.offset = 0
            raise StopIteration
        raise item[1]  # "err": the worker's exception, on the consumer

    def state_dict(self):
        """Consumed position only — staged-ahead batches are NOT counted
        (they will be re-staged by the resumed run)."""
        return {"epoch": self.epoch, "offset": self.offset}

    def load_state_dict(self, state):
        self.close()
        self.epoch = int(state["epoch"])
        self.offset = 0
        self._pending_skip = int(state["offset"])

    def close(self):
        """Stop the worker and drop staged batches (idempotent)."""
        self._stop.set()
        self._join_worker()
        self._q = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # -- epoch / worker machinery -------------------------------------------
    def _start_epoch(self):
        ctx = current_context()
        self._dev = ctx.torch_device
        if self._dev.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self._dev)
        src = self._source
        if hasattr(src, "reset"):
            src.reset()
        it = iter(src)
        # resume fast-forward runs on THIS thread so a failure surfaces
        # synchronously at the load site, not as a worker error later
        skip = self._pending_skip
        for n in range(skip):
            try:
                next(it)
            except StopIteration:
                raise MXNetError(
                    "cannot fast-forward data source to offset "
                    f"{skip}: exhausted at {n}") from None
        self._pending_skip = 0
        self.offset = skip
        self._q = queue.Queue(self._depth)
        self._stop = threading.Event()
        t = threading.Thread(target=self._worker, args=(it, ctx),
                             name="DevicePrefetcher", daemon=True)
        t.start()
        self._worker_t = t

    def _join_worker(self):
        t = self._worker_t
        self._worker_t = None
        if t is not None and t.is_alive():
            self._stop.set()
            t.join(timeout=5.0)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._dev))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _worker(self, it, ctx):
        try:
            with ctx, self._on_stream():
                group = []
                for batch in it:
                    if self._stop.is_set():
                        return
                    leaves = _leaves(batch)
                    if group and [t.shape for t in leaves] != \
                            [t.shape for t in group[0]]:
                        # ragged batch (e.g. last_batch='keep'): close the
                        # group early so every stack stays rectangular
                        self._stage(group)
                        group = []
                    group.append(leaves)
                    if len(group) >= (self._k or 1):
                        self._stage(group)
                        group = []
                if group:
                    self._stage(group)
            self._put(("end",))
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._put(("err", e))

    def _stage(self, group):
        """Stack ``group``'s columns on the device (on the staging stream,
        which this thread runs on) and queue them with the event that
        marks their copies done."""
        from ...testing import chaos

        chaos.fault_point("prefetch.stage")
        dev = self._dev
        arrays = []
        for col in zip(*group):
            if self._k is None:
                arrays.append(to_device(col[0], dev, True))
            elif all(t.device == dev for t in col):
                arrays.append(torch.stack(col))
            else:
                arrays.append(to_device(torch.stack([t.cpu() for t in col]),
                                        dev, True))
        staged = None
        if self._stream is not None:
            staged = torch.cuda.Event()
            staged.record(self._stream)
        self._put(("batch", tuple(arrays), len(group), staged))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue
