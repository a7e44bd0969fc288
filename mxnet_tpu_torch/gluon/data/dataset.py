"""Dataset containers and combinators for ``gluon.data``.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py`` (reference:
python/mxnet/gluon/data/dataset.py). Every combinator
(``shard``/``take``/``sample``/``transform``) returns a lazy *view* built on
a single ``_IndexView``/``_MappedView`` pair instead of eagerly
materializing a python list, so sharding a dataset across workers touches
no sample until the loader asks for it. ``transform(..., lazy=False)`` opts
into eager materialization. The views and ``transform_first``'s wrapper
are picklable when the base dataset and the function are, so a transformed
dataset goes to spawned ``DataLoader`` workers.

``RecordFileDataset`` reads an indexed RecordIO file through the native
engine of ``src/io_native/recordio.cc`` (:mod:`mxnet_tpu_torch.recordio`).
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Random-access collection: ``__getitem__`` + ``__len__``.

    Samples flow host-side (numpy) through the data pipeline; batches are
    moved to the device once, after collation, by the DataLoader.
    """

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    # -- combinators (all lazy unless stated) -------------------------------
    def filter(self, fn):
        """Keep samples where ``fn(sample)``; evaluates ``fn`` eagerly once
        (the survivor index list must be known for ``__len__``)."""
        kept = [i for i in range(len(self)) if fn(self[i])]
        return _IndexView(self, kept)

    def shard(self, num_shards, index):
        """Contiguous 1/num_shards slice (shard ``index``) as a lazy view;
        the first ``len % num_shards`` shards get one extra sample, so
        shard sizes differ by at most one (shard before shuffling so each
        data-parallel worker sees a unique subset)."""
        if not 0 <= index < num_shards:
            raise MXNetError(
                f"shard index {index} out of range for {num_shards} shards")
        n = len(self)
        base, extra = divmod(n, num_shards)
        lo = base * index + min(index, extra)
        hi = lo + base + (1 if index < extra else 0)
        return _IndexView(self, range(lo, hi))

    def take(self, count):
        """First ``count`` samples as a lazy view."""
        return _IndexView(self, range(min(count, len(self))))

    def sample(self, sampler):
        """Reorder/subset by a Sampler's index stream (drawn once, now)."""
        return _IndexView(self, list(sampler))

    def transform(self, fn, lazy=True):
        """Apply ``fn`` to whole samples; eager when ``lazy=False``."""
        view = _MappedView(self, fn)
        return view if lazy else SimpleDataset([view[i]
                                                for i in range(len(view))])

    def transform_first(self, fn, lazy=True):
        """Apply ``fn`` to the data element, passing labels through — the
        standard augmentation hook (augment image, keep label)."""
        return self.transform(_FirstOnly(fn), lazy=lazy)


class _FirstOnly:
    """``fn`` on a sample's first element; a class, not a closure, so a
    transformed dataset pickles for spawned workers."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, sample):
        if isinstance(sample, tuple) and len(sample) > 1:
            return (self._fn(sample[0]),) + sample[1:]
        if isinstance(sample, tuple):  # 1-tuple unwraps to a bare value
            return self._fn(sample[0])
        return self._fn(sample)


class _IndexView(Dataset):
    """Lazy re-indexing of a base dataset (shard/take/sample/filter)."""

    def __init__(self, base, indices):
        self._base = base
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._base[self._indices[idx]]


class _MappedView(Dataset):
    """Lazy per-sample function application."""

    def __init__(self, base, fn):
        self._base = base
        self._fn = fn

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        return self._fn(self._base[idx])


class SimpleDataset(Dataset):
    """Wrap any random-access python container as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip N equal-length arrays into (a[i], b[i], …) tuples; a single
    array yields bare samples."""

    def __init__(self, *arrays):
        if not arrays:
            raise MXNetError("ArrayDataset needs at least one array")
        lengths = {len(a) for a in arrays}
        if len(lengths) != 1:
            raise MXNetError(
                f"all arrays must have the same length, got {sorted(lengths)}")
        self._arrays = arrays

    def __len__(self):
        return len(self._arrays[0])

    def __getitem__(self, idx):
        if len(self._arrays) == 1:
            return self._arrays[0][idx]
        return tuple(a[idx] for a in self._arrays)


class RecordFileDataset(Dataset):
    """Raw records of a RecordIO ``.rec`` file (reference:
    gluon/data/dataset.py RecordFileDataset:390): each sample is a record's
    bytes, in the order of the ``.idx`` sidecar with the same stem, which
    is required.

    Picklable for spawned ``DataLoader`` workers: ``__getstate__`` closes
    the open reader (its native handle) and leaves it out, and the worker
    opens its own at its first sample.
    """

    def __init__(self, filename):
        import os

        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        if not os.path.exists(self.idx_file):
            raise MXNetError(
                f"RecordFileDataset: index sidecar {self.idx_file!r} not "
                "found: a silent empty dataset would train on nothing")
        self._record = None
        if len(self._reader().keys) == 0:
            raise MXNetError(
                f"RecordFileDataset: {filename!r} has no indexed records")

    def _reader(self):
        if self._record is None:
            from ...recordio import MXIndexedRecordIO

            self._record = MXIndexedRecordIO(self.idx_file, self.filename,
                                             "r")
        return self._record

    def __getstate__(self):
        if self._record is not None:
            self._record.close()
            self._record = None
        return self.__dict__.copy()

    def __getitem__(self, idx):
        rec = self._reader()
        return rec.read_idx(rec.keys[idx])

    def __len__(self):
        return len(self._reader().keys)
