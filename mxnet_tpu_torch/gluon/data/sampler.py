"""Index samplers for ``gluon.data.DataLoader``.

Counterpart of ``mxnet_tpu/gluon/data/sampler.py`` (reference:
python/mxnet/gluon/data/sampler.py), the same code: every sampler is an
index *stream generator* over ``range(length)`` (no state mutated during
iteration except BatchSampler's explicit rollover buffer), and
RandomSampler takes an optional numpy ``Generator``/seed, so the two
packages draw the same permutation from one seed. Samplers run in the
loader's process; workers receive index lists.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FilterSampler"]


class Sampler:
    """Iterable of dataset indices (or of index lists, for batch samplers)."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """Indices ``start, start+1, …, start+length-1`` in order."""

    def __init__(self, length, start=0):
        self._range = range(start, start + length)

    def __iter__(self):
        return iter(self._range)

    def __len__(self):
        return len(self._range)


class RandomSampler(Sampler):
    """A fresh uniform permutation of ``range(length)`` each epoch."""

    def __init__(self, length, rng=None):
        self._n = length
        if rng is None or isinstance(rng, (int, onp.integer)):
            rng = onp.random.default_rng(rng)
        self._rng = rng

    def __iter__(self):
        yield from self._rng.permutation(self._n).tolist()

    def __len__(self):
        return self._n


class IntervalSampler(Sampler):
    """Stride through the dataset: ``0, k, 2k, …`` then (with rollover)
    ``1, k+1, …`` and so on — useful for interleaved corpora like
    consecutive-frame video datasets."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError(
                f"interval {interval} larger than dataset length {length}")
        self._n = length
        self._stride = interval
        self._phases = interval if rollover else 1

    def __iter__(self):
        for phase in range(self._phases):
            yield from range(phase, self._n, self._stride)

    def __len__(self):
        if self._phases == self._stride:
            return self._n
        return (self._n + self._stride - 1) // self._stride


class FilterSampler(Sampler):
    """Indices of samples for which ``fn(dataset[i])`` is truthy; the
    predicate is evaluated once, eagerly, at construction."""

    def __init__(self, fn, dataset):
        self._kept = tuple(
            i for i, sample in enumerate(dataset) if fn(sample))

    def __iter__(self):
        return iter(self._kept)

    def __len__(self):
        return len(self._kept)


class BatchSampler(Sampler):
    """Group a sampler's index stream into ``batch_size``-long lists.

    ``last_batch``: ``'keep'`` yields the short tail batch, ``'discard'``
    drops it, ``'rollover'`` saves it to prepend to the next epoch.
    """

    _MODES = ("keep", "discard", "rollover")

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in self._MODES:
            raise ValueError(
                f"last_batch must be one of {self._MODES}, got {last_batch}")
        self._source = sampler
        self._bs = batch_size
        self._tail_mode = last_batch
        self._carried = []

    def __iter__(self):
        batch = list(self._carried)
        self._carried = []
        for idx in self._source:
            batch.append(idx)
            if len(batch) == self._bs:
                yield batch
                batch = []
        if not batch:
            return
        if self._tail_mode == "keep":
            yield batch
        elif self._tail_mode == "rollover":
            self._carried = batch
        # 'discard': tail is dropped

    def __len__(self):
        n = len(self._source) + len(self._carried)
        if self._tail_mode == "keep":
            return -(-n // self._bs)
        # 'discard' drops the tail; 'rollover' carries it to the next
        # epoch — either way only full batches are yielded this epoch
        return n // self._bs
