"""Picklable datasets and functions for the port's spawned-worker tests.

Spawned ``DataLoader`` workers unpickle a dataset by importing the module
that defines it. This module imports only numpy, os and torch, so a worker
pays no JAX import; it is a helper of ``tests/test_torch_data.py`` and
``tests/test_torch_prefetcher.py``, not a test.
"""
import os

import numpy as onp


def record_pid(path):
    """Append this process's pid to ``path``; the sample is 0.0."""
    with open(path, "a") as f:
        f.write(f"{os.getpid()}\n")
    return 0.0


class WorkerReport:
    """Sample i is (pid, CUDA initialised, CUDA_VISIBLE_DEVICES, devices
    seen, the device an NDArray made here lands on) of the process that
    loads it."""

    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        import torch

        from mxnet_tpu_torch import np as mnp

        where = str(mnp.zeros((1,))._data.device)
        return (os.getpid(), bool(torch.cuda.is_initialized()),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count(), where)


class Tokens:
    """``n`` windows of ``t`` tokens and their shifted targets, from a
    seed."""

    def __init__(self, n, t, vocab=50, seed=0):
        rng = onp.random.RandomState(seed)
        seq = rng.randint(0, vocab, (n, t + 1)).astype("int32")
        self.x, self.y = seq[:, :-1], seq[:, 1:]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]
