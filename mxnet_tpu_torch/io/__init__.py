"""mx.io — iterator-style data pipeline (reference: python/mxnet/io/io.py:
DataIter:179, NDArrayIter:490, MXDataIter:799 over src/io/ N15).

Counterpart of the Python iterators of ``mxnet_tpu/io/__init__.py``
(:24-224, :490-599): ``DataBatch``, ``DataIter``, ``NDArrayIter``,
``ResizeIter`` and ``PrefetchingIter``. Arrays are held on the host and each
batch becomes NDArrays on the current context. Every iterator's ``__next__``
records its wait in the port's telemetry registry (the
``io.<class>.batch`` timer; always on, where the reference records it only
with its telemetry enabled).

``CSVIter`` and ``LibSVMIter`` (:226-330) read through the native
threaded text parser of ``src/io_native/textparse.cc``, built with the
host's C++ compiler at first use (:mod:`._textparse`). ``LibSVMIter``
yields dense batches, or with ``sparse=True`` ``CSRNDArray`` batches on the
current context that feed ``mx.nd.sparse.dot`` without densifying; a
batch's entries are gathered with a few numpy calls, not one per row.
``ImageRecordIter`` streams a ``.rec`` file through the native RecordIO
engine of ``src/io_native/recordio.cc`` (:mod:`._native`) and decodes and
augments its images on a thread pool, with the reference's keywords.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as onp

from .. import recordio as _recordio
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "ResizeIter", "PrefetchingIter"]


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data if isinstance(data, list) else [data]
        self.label = (label if isinstance(label, list) else
                      [label] if label is not None else [])
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [d.shape for d in self.data]
        return f"DataBatch: data shapes: {shapes} pad: {self.pad}"


def _timed_next(nxt):
    """Wrap a ``__next__`` with the batch-latency timer (per-class timer
    names, as the reference's step report reads them)."""
    import functools
    import time as _time

    from .. import telemetry as _tm

    @functools.wraps(nxt)
    def timed(self):
        t0 = _time.perf_counter()
        batch = nxt(self)  # StopIteration propagates untimed
        _tm.timer(f"io.{type(self).__name__}.batch").record(
            _time.perf_counter() - t0)
        return batch

    timed._telemetry_wrapped = True
    return timed


class DataIter:
    """Iterator base (reference: io.py DataIter:179)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __init_subclass__(cls, **kwargs):
        # every concrete iterator gets the batch timer, whether it uses the
        # base __next__ or overrides it
        super().__init_subclass__(**kwargs)
        nxt = cls.__dict__.get("__next__")
        if nxt is not None and not getattr(nxt, "_telemetry_wrapped", False):
            cls.__next__ = _timed_next(nxt)

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        """Legacy-style accessor ('while True: batch = it.next()')."""
        if type(self).__next__ is not DataIter.__next__:
            return self.__next__()
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def device_prefetch(self, multi_step=None, depth=None, sharding=None):
        """Wrap this iterator in a ``gluon.data.DevicePrefetcher``: stack
        groups of ``multi_step`` batches into ``[K, batch, ...]`` super-
        batches on the device, staged on a stream of their own while the
        previous group computes. ``reset()`` is driven by the prefetcher at
        epoch starts."""
        from ..gluon.data.prefetcher import DevicePrefetcher

        return DevicePrefetcher(self, multi_step=multi_step, depth=depth,
                                sharding=sharding)

    def getpad(self):
        return 0


# the base __next__ serves every iterator that doesn't override it
# (NDArrayIter et al.); wrap it once so those are timed too
DataIter.__next__ = _timed_next(DataIter.__next__)


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py NDArrayIter:490)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"invalid last_batch_handle "
                             f"{last_batch_handle!r}")
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name) if label is not None \
            else []
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._leftover = onp.array([], dtype=onp.int64)
        self._order = onp.arange(self.num_data)
        if shuffle:
            onp.random.shuffle(self._order)

    @staticmethod
    def _init_data(data, default_name):
        if data is None:
            return []
        if isinstance(data, (onp.ndarray, NDArray)):
            data = [(default_name, data)]
        elif isinstance(data, dict):
            data = list(data.items())
        elif isinstance(data, (list, tuple)):
            data = [(f"{default_name}_{i}" if i else default_name, d)
                    for i, d in enumerate(data)]
        out = []
        for name, d in data:
            arr = d.asnumpy() if isinstance(d, NDArray) else onp.asarray(d)
            out.append((name, arr))
        return out

    @property
    def provide_data(self):
        return [(name, (self.batch_size,) + d.shape[1:])
                for name, d in self.data]

    @property
    def provide_label(self):
        return [(name, (self.batch_size,) + d.shape[1:])
                for name, d in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        base = onp.arange(self.num_data)
        if self.shuffle:
            onp.random.shuffle(base)
        if self.last_batch_handle == "roll_over" and len(self._leftover):
            # rolled-over samples lead the next epoch (reference semantics)
            base = onp.concatenate([self._leftover, base])
            self._leftover = onp.array([], dtype=onp.int64)
        self._order = base

    def iter_next(self):
        self.cursor += self.batch_size
        n = len(self._order)
        if self.last_batch_handle == "pad":
            return self.cursor < n
        if self.cursor + self.batch_size <= n:
            return True
        if self.last_batch_handle == "roll_over" and self.cursor < n:
            self._leftover = self._order[self.cursor:]
        return False

    def _slice(self, arrays):
        out = []
        for _, arr in arrays:
            idx = self._order[self.cursor:self.cursor + self.batch_size]
            chunk = arr[idx]
            if len(chunk) < self.batch_size and \
                    self.last_batch_handle == "pad":
                need = self.batch_size - len(chunk)
                chunk = onp.concatenate([chunk, arr[self._order[:need]]])
            out.append(NDArray(chunk))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        n = len(self._order)
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > n:
            return self.cursor + self.batch_size - n
        return 0


class CSVIter(DataIter):
    """CSV reader (reference: src/io iter_csv.cc): the whole file parsed
    by the native scanner, then batched as :class:`NDArrayIter` batches."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        from ._textparse import parse_csv

        data = parse_csv(str(data_csv))
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = parse_csv(str(label_csv))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        self._inner = NDArrayIter(data, label, batch_size, **kwargs)
        super().__init__(batch_size)

    def __getattr__(self, name):
        if name == "_inner":  # half-built instance (pickle/failed init)
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __next__(self):
        return next(self._inner)

    def reset(self):
        self._inner.reset()


class LibSVMIter(DataIter):
    """LibSVM reader (reference: src/io/iter_libsvm.cc), rows ``label
    idx:val ...``: dense (batch, num_features) batches, or with
    ``sparse=True`` ``CSRNDArray`` batches on the current context (the
    matrix is never densified). Features at or past ``data_shape[0]`` are
    dropped; a last partial batch is padded from the file's start
    (``last_batch_handle="pad"``, its ``pad`` set) or dropped
    (``"discard"``). The whole parsed CSR triple is ``csr``."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 last_batch_handle="pad", sparse=False, **kwargs):
        from ._textparse import parse_libsvm

        self._sparse = sparse
        labels, indptr, indices, values = parse_libsvm(str(data_libsvm))
        self._labels = labels
        self._indptr = indptr
        self._indices = indices
        self._values = values
        self._num_feat = int(data_shape[0]) if data_shape else \
            (int(indices.max()) + 1 if indices.size else 1)
        self._cursor = 0
        self._last_batch_handle = last_batch_handle
        super().__init__(batch_size)
        self.provide_data = [("data", (batch_size, self._num_feat))]
        self.provide_label = [("softmax_label", (batch_size,))]

    @property
    def csr(self):
        return self._indptr, self._indices, self._values

    def _row_entries(self, rows):
        """(batch_row_ids, entry_ids) of the stored entries of ``rows``,
        features >= num_feat dropped; the entries of each row are a run
        of the file's arrays, expanded for all rows at once."""
        starts = self._indptr[rows]
        counts = self._indptr[rows + 1] - starts
        ends = onp.cumsum(counts)
        flat_r = onp.repeat(onp.arange(len(rows)), counts)
        flat_i = onp.arange(ends[-1] if len(rows) else 0) + \
            onp.repeat(starts - (ends - counts), counts)
        keep = self._indices[flat_i] < self._num_feat
        return flat_r[keep], flat_i[keep]

    def _dense_rows(self, rows):
        out = onp.zeros((len(rows), self._num_feat), "float32")
        flat_r, flat_i = self._row_entries(rows)
        out[flat_r, self._indices[flat_i]] = self._values[flat_i]
        return out

    def __next__(self):
        n = len(self._labels)
        if self._cursor >= n:
            raise StopIteration
        idx = onp.arange(self._cursor,
                         min(self._cursor + self.batch_size, n))
        pad = self.batch_size - len(idx)
        if pad and self._last_batch_handle == "discard":
            self._cursor = n
            raise StopIteration
        if pad:  # wrap around (the reference's "pad")
            idx = onp.concatenate([idx, onp.arange(pad)])
        self._cursor += self.batch_size
        if self._sparse:
            data = self._csr_rows(idx)
        else:
            data = NDArray(self._dense_rows(idx))
        label = NDArray(self._labels[idx])
        return DataBatch(data=[data], label=[label], pad=pad)

    def _csr_rows(self, rows):
        from ..ndarray.sparse import CSRNDArray

        flat_r, flat_i = self._row_entries(rows)
        counts = onp.bincount(flat_r, minlength=len(rows))
        indptr = onp.zeros(len(rows) + 1, "int64")
        onp.cumsum(counts, out=indptr[1:])
        return CSRNDArray(self._values[flat_i].astype("float32"),
                          self._indices[flat_i], indptr,
                          (len(rows), self._num_feat), ctx=current_context(),
                          indptr_host=indptr)

    def reset(self):
        self._cursor = 0


class ImageRecordIter(DataIter):
    """Batches of images from a ``.rec`` file of ``recordio.pack_img``
    records (reference: src/io/iter_image_recordio_2.cc:887 and
    ``mxnet_tpu/io/__init__.py:346-488``).

    The native engine's prefetch thread (``src/io_native/recordio.cc``)
    streams each batch's records; a pool of ``preprocess_threads`` threads
    decodes them with PIL and augments them with numpy: the shorter edge
    resized to ``resize``, a crop of ``data_shape`` (random with
    ``rand_crop``, else central), a mirror with ``rand_mirror``, then
    ``(x - mean) / std`` per channel, in (C, H, W) float32. Each batch moves
    to the current context once.

    The crop offsets and mirror flips are drawn from one
    ``RandomState(seed)`` in record order, on the caller's thread, before
    the decodes are dispatched (each image's size is read from its header
    first), so any thread count gives the batches of one thread. The
    reference draws inside its pool threads, where more than one thread
    races; its one-thread batches are the port's.
    """

    _KNOWN_KWARGS = frozenset({"preprocess_threads", "label_name",
                               "data_name", "prefetch_buffer", "ctx",
                               "dtype", "verbose", "num_parts", "part_index",
                               "path_imgidx"})

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=-1, round_batch=True, seed=0, **kwargs):
        import concurrent.futures

        from ._native import get_lib

        super().__init__(batch_size)
        self._prefetch = self._reader = self._pool = None
        unknown = set(kwargs) - self._KNOWN_KWARGS
        if unknown:
            import warnings

            warnings.warn(f"ImageRecordIter: ignoring unknown options "
                          f"{sorted(unknown)}", stacklevel=2)
        self._round_batch = round_batch
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = onp.array([mean_r, mean_g, mean_b],
                               dtype="float32").reshape(3, 1, 1)
        self._std = onp.array([std_r, std_g, std_b],
                              dtype="float32").reshape(3, 1, 1)
        self._rng = onp.random.RandomState(seed)
        self._lib = get_lib()
        self._path = path_imgrec
        self._reader = self._lib.rio_reader_open(path_imgrec.encode())
        if not self._reader:
            raise MXNetError(f"cannot open record file {path_imgrec}")
        self._count = self._lib.rio_reader_count(self._reader)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(kwargs.get("preprocess_threads", 4)))
        self.reset()

    @property
    def num_records(self):
        return self._count

    def reset(self):
        if self._prefetch:
            self._lib.rio_prefetch_free(self._prefetch)
            self._prefetch = None
        order = onp.arange(self._count, dtype=onp.uint64)
        if self._shuffle:
            self._rng.shuffle(order)
        arr = (ctypes.c_uint64 * len(order))(*order.tolist())
        self._prefetch = self._lib.rio_prefetch_create(
            self._reader, arr, len(order), self.batch_size)

    def _resized(self, ih, iw):
        """The (height, width) of an (ih, iw) image after its shorter edge
        is resized to ``resize`` (when positive), and after that is
        stretched up to ``data_shape`` where smaller (reference
        :404-420)."""
        _, h, w = self.data_shape
        if self._resize > 0:
            ih, iw = (self._resize, int(iw * self._resize / ih)) \
                if ih < iw else (int(ih * self._resize / iw), self._resize)
        return (ih, iw), (max(h, ih), max(w, iw))

    def _draws(self, payload):
        """One record's crop offsets and flip, drawn in the reference's
        order: the row offset, the column offset, then the mirror's
        uniform."""
        import io as _pyio

        from PIL import Image

        _, h, w = self.data_shape
        iw, ih = Image.open(_pyio.BytesIO(_recordio.unpack(payload)[1])).size
        _, (ih, iw) = self._resized(ih, iw)
        if self._rand_crop and (ih > h or iw > w):
            y0 = self._rng.randint(0, ih - h + 1)
            x0 = self._rng.randint(0, iw - w + 1)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        flip = bool(self._rand_mirror and self._rng.rand() < 0.5)
        return y0, x0, flip

    def _decode_one(self, payload, y0, x0, flip):
        from ..gluon.data.vision.transforms import _resize_np

        header, img = _recordio.unpack_img(payload)
        _, h, w = self.data_shape
        (rh, rw), (sh, sw) = self._resized(img.shape[0], img.shape[1])
        if self._resize > 0:
            img = _resize_np(img, (rw, rh))
        if (sh, sw) != (rh, rw):
            img = _resize_np(img, (sw, sh))
        img = img[y0:y0 + h, x0:x0 + w]
        if flip:
            img = img[:, ::-1]
        chw = img.astype("float32").transpose(2, 0, 1)
        chw = (chw - self._mean) / self._std
        label = header.label if header.flag else float(header.label)
        return chw, label

    def __next__(self):
        data_p = ctypes.c_char_p()
        off_p = ctypes.POINTER(ctypes.c_uint64)()
        nbytes = ctypes.c_uint64()
        n = self._lib.rio_prefetch_next(self._prefetch,
                                        ctypes.byref(data_p),
                                        ctypes.byref(off_p),
                                        ctypes.byref(nbytes))
        if n <= 0:
            raise StopIteration
        blob = ctypes.string_at(data_p, nbytes.value)
        offsets = [off_p[i] for i in range(n + 1)]
        self._lib.rio_prefetch_release(self._prefetch)
        payloads = [blob[offsets[i]:offsets[i + 1]] for i in range(n)]
        draws = [self._draws(p) for p in payloads]
        futures = [self._pool.submit(self._decode_one, p, *d)
                   for p, d in zip(payloads, draws)]
        imgs = onp.empty((self.batch_size,) + self.data_shape, "float32")
        labels = onp.zeros((self.batch_size, self.label_width), "float32")
        for i, fut in enumerate(futures):
            imgs[i], labels[i] = fut.result()
        pad = self.batch_size - n
        if pad and not self._round_batch:
            imgs, labels = imgs[:n], labels[:n]  # short final batch
            pad = 0
        elif pad:
            imgs[n:] = imgs[:1]
            labels[n:] = labels[:1]
        lab = labels[:, 0] if self.label_width == 1 else labels
        return DataBatch([NDArray(imgs)], [NDArray(lab)], pad=pad)

    def __del__(self):
        # the prefetch thread is joined before its reader is freed, and the
        # decode pool's threads end with it
        if getattr(self, "_prefetch", None):
            self._lib.rio_prefetch_free(self._prefetch)
            self._prefetch = None
        if getattr(self, "_reader", None):
            self._lib.rio_reader_free(self._reader)
            self._reader = None
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class ResizeIter(DataIter):
    """Stretch/limit another iterator to a fixed number of batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def __next__(self):
        if self.cur >= self.size:
            raise StopIteration
        self.cur += 1
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter.reset()
            return next(self.data_iter)


class PrefetchingIter(DataIter):
    """Thread that stays one batch ahead (reference: iter_prefetcher.h)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if isinstance(iters, list):
            if len(iters) != 1:
                raise MXNetError("multi-iterator prefetching is not "
                                 "supported; pass one iterator")
            iters = iters[0]
        if rename_data is not None or rename_label is not None:
            raise MXNetError("rename_data/rename_label are not supported")
        super().__init__(iters.batch_size)
        self._iter = iters
        self._queue: list = []
        self._cv = threading.Condition()
        self._done = False
        self._thread = None
        self._start_worker()

    def _start_worker(self):
        # generation-scoped state: a stale worker from a previous epoch holds
        # references to ITS OWN queue/flag objects, so even if it outlives a
        # reset it can never pollute the new epoch's queue
        self._queue = []
        self._done = [False]
        self._error = None
        # the caller's context, entered by the worker: a context scope is
        # per thread, and the wrapped iterator makes its NDArrays there
        self._thread = threading.Thread(
            target=self._worker,
            args=(self._queue, self._done, current_context()), daemon=True)
        self._thread.start()

    def _worker(self, queue, done, ctx):
        try:
            with ctx:
                for batch in self._iter:
                    with self._cv:
                        while len(queue) >= 2 and not done[0]:
                            self._cv.wait(0.1)
                        if done[0]:
                            return
                        queue.append(batch)
                        self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — surface in consumer
            with self._cv:
                if not done[0]:
                    self._error = e
        finally:
            with self._cv:
                queue.append(None)
                self._cv.notify_all()

    def reset(self):
        """Stop the worker, reset the wrapped iterator, start a new epoch."""
        with self._cv:
            self._done[0] = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                # the worker is still inside next(self._iter): re-entering
                # the iterator now would have two threads driving it —
                # fail loudly instead of corrupting state
                raise MXNetError(
                    "PrefetchingIter.reset: worker still busy after 30s; "
                    "the wrapped iterator is blocked — cannot safely reset")
        self._iter.reset()
        self._start_worker()

    def __next__(self):
        with self._cv:
            while not self._queue:
                self._cv.wait()
            batch = self._queue.pop(0)
            self._cv.notify_all()
        if batch is None:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return batch

    def __del__(self):
        try:
            self._done[0] = True
        except Exception:  # noqa: BLE001
            pass
