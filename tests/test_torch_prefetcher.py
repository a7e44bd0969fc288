"""PyTorch/CUDA port: ``DevicePrefetcher`` and its feed of the compiled
multi-step.

- The JAX package's ``tests/test_multi_step.py:249-296`` cases: stacked
  ``[K, B, ...]`` groups, consumed-position offsets, a mid-epoch resume that
  skips exactly the consumed source batches, a ragged batch closing its
  group early, and a fault armed at ``prefetch.stage`` surfacing as
  ``MXNetError``; the groups equal the JAX package's prefetcher's on the
  same source.
- The stall and worker-death errors; ``sharding`` raises (not ported).
- Sources: a list, a ``DataLoader`` with spawned workers
  (``loader.device_prefetch``), an ``io.NDArrayIter``
  (``DataIter.device_prefetch``) whose batches the worker thread makes
  under the consumer's ``with mx.cpu():``.
- The prefetcher into ``compile_step(...).compile_multi_step(4)`` on twin
  ``gpt_tiny`` models: losses and weights bitwise equal to the twin fed
  hand-stacked groups, a trailing group of 2 included (it reuses the
  one-step program: no second capture).
- On the card (``cuda``-marked): a large group staged on the prefetcher's
  stream while the previous group's graph replays gives results bitwise
  equal to synchronous copies, and the compiled multi-step fed by the
  prefetcher equals its hand-fed twin.

Tolerance: none; every comparison is bitwise. The JAX package is imported
inside the tests that use it, so ``pytest --noconftest ... -m cuda``
collects this file without JAX.
"""
import os
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, io as tio
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader,
                                        DevicePrefetcher, RandomSampler)
from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny
from mxnet_tpu_torch.testing import chaos

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_data_workers import Tokens  # noqa: E402
from torch_parity import numpy_weights  # noqa: E402


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _batches(n=10):
    return [(onp.full((4, 3), i, onp.float32), onp.full((4,), i, onp.float32))
            for i in range(n)]


def test_groups_offsets_resume_and_ragged():
    batches = _batches()
    pf = DevicePrefetcher(batches, multi_step=4)
    groups = list(pf)
    assert [g[0].shape for g in groups] == [(4, 4, 3), (4, 4, 3), (2, 4, 3)]
    assert onp.array_equal(groups[0][0].asnumpy()[:, 0, 0], [0, 1, 2, 3])
    assert (pf.epoch, pf.offset) == (1, 0)
    it = iter(pf)
    next(it)
    assert pf.state_dict() == {"epoch": 1, "offset": 4}
    next(it)
    assert pf.state_dict()["offset"] == 8
    pf.close()
    pf2 = DevicePrefetcher(batches, multi_step=4)
    pf2.load_state_dict({"epoch": 1, "offset": 8})
    g = next(iter(pf2))
    assert list(g[0].asnumpy()[:, 0, 0]) == [8, 9]
    pf2.close()
    ragged = [(onp.zeros((4, 3), onp.float32),)] * 3 + \
        [(onp.zeros((2, 3), onp.float32),)]
    pf3 = DevicePrefetcher(ragged, multi_step=4)
    assert [g[0].shape for g in pf3] == [(3, 4, 3), (1, 2, 3)]
    pf3.close()
    single = DevicePrefetcher(batches[:3])
    assert [g[1].shape for g in single] == [(4,)] * 3
    with pytest.raises(MXNetError, match="exhausted"):
        bad = DevicePrefetcher(batches, multi_step=4)
        bad.load_state_dict({"epoch": 0, "offset": 11})
        next(bad)


def test_groups_match_jax():
    from mxnet_tpu.gluon.data import DevicePrefetcher as JPrefetcher

    batches = _batches(7)
    got = [[a.asnumpy() for a in g]
           for g in DevicePrefetcher(batches, multi_step=3)]
    want = [[a.asnumpy() for a in g]
            for g in JPrefetcher(batches, multi_step=3)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and onp.array_equal(a, b)


@pytest.mark.chaos
def test_chaos_stage_fault():
    batches = [(onp.zeros((4, 3), onp.float32),) for _ in range(8)]
    chaos.inject("prefetch.stage", "raise")
    try:
        pf = DevicePrefetcher(batches, multi_step=4, timeout=10.0)
        with pytest.raises(MXNetError):
            next(iter(pf))
        pf.close()
    finally:
        chaos.clear()


class _Wedged:
    def __iter__(self):
        time.sleep(1.0)
        yield (onp.zeros(2),)


def test_stall_death_and_sharding():
    pf = DevicePrefetcher(_Wedged(), timeout=0.3)
    with pytest.raises(MXNetError, match="stalled"):
        next(pf)
    pf.close()
    # a worker gone without its last report (as one killed mid-stage): the
    # epoch's end is taken off the queue before the consumer looks
    pf = DevicePrefetcher([])
    pf._start_epoch()
    pf._worker_t.join(timeout=5)
    pf._q.get(timeout=5)               # the epoch's end, taken away
    with pytest.raises(MXNetError, match="died"):
        next(pf)
    with pytest.raises(MXNetError, match="A8"):
        DevicePrefetcher([], sharding=object())
    with pytest.raises(MXNetError, match=">= 1"):
        DevicePrefetcher([], multi_step=0)


def test_sources_loader_with_processes_and_ndarray_iter():
    """The loader's spawned workers and the iterator's NDArrays (made in the
    prefetcher's thread, under the consumer's ``with mx.cpu():``)."""
    ds = Tokens(22, 6)
    loader = DataLoader(ArrayDataset(ds.x, ds.y), batch_size=4,
                        sampler=RandomSampler(22, rng=3), num_workers=2)
    got = [tuple(a.asnumpy() for a in g)
           for g in loader.device_prefetch(multi_step=2)]
    order = list(RandomSampler(22, rng=3))
    rows = [order[i:i + 4] for i in range(0, 22, 4)]
    assert [g[0].shape for g in got] == [(2, 4, 6)] * 2 + [(1, 4, 6),
                                                            (1, 2, 6)]
    flat = [b for g in got for b in zip(*g)]
    for (x, y), idx in zip(flat, rows):
        assert onp.array_equal(x, ds.x[idx]) and onp.array_equal(y, ds.y[idx])
    it = tio.NDArrayIter(ds.x, ds.y, batch_size=5,
                         last_batch_handle="discard")
    groups = list(it.device_prefetch(multi_step=2))
    assert [g[0].shape for g in groups] == [(2, 5, 6), (2, 5, 6)]
    assert all(a.ctx == tmx.cpu() for g in groups for a in g)
    assert onp.array_equal(groups[1][0].asnumpy()[1], ds.x[15:20])


def _twins(device, seed=31):
    kw = dict(vocab_size=50, dropout=0.0, num_layers=2, units=32,
              num_heads=4, max_length=16)
    nets = []
    for _ in range(2):
        net = gpt_tiny(device=device, **kw)
        net.load_dict(numpy_weights({n: tuple(p.shape) for n, p in
                                     net.collect_params().items()}, seed))
        nets.append(net)
    return nets


def _compiled(net):
    tr = Trainer(net.collect_params(), "adamw",
                 {"learning_rate": 2e-3, "wd": 0.05, "epsilon": 1e-4})
    return tr.compile_step(net, tloss.SoftmaxCrossEntropyLoss()) \
        .compile_multi_step(4)


def _prefetcher_vs_hand(device, n_batches=10, B=3, T=8):
    """Losses of the prefetcher-fed twin and of the hand-fed twin, and both
    nets."""
    ds = Tokens(n_batches * B, T, vocab=50, seed=2)
    data = ArrayDataset(ds.x, ds.y)
    fed, hand = _twins(device)
    step_fed, step_hand = _compiled(fed), _compiled(hand)
    loader = DataLoader(data, batch_size=B, sampler=RandomSampler(
        len(data), rng=7))
    got = [step_fed(xs, ys) for xs, ys in loader.device_prefetch(4)]
    serial = list(DataLoader(data, batch_size=B,
                             sampler=RandomSampler(len(data), rng=7)))
    want = []
    for i in range(0, len(serial), 4):
        group = serial[i:i + 4]
        xs = torch.stack([b[0]._data for b in group])
        ys = torch.stack([b[1]._data for b in group])
        want.append(step_hand(xs, ys))
    assert [g.shape for g in got] == [(4,), (4,), (2,)]
    assert step_fed._traces == step_hand._traces == 1
    return got, want, fed, hand


def _bitwise(got, want, fed, hand):
    for a, b in zip(got, want):
        assert torch.equal(a._data, b)
    for (n, p), q in zip(fed.collect_params().items(),
                         hand.collect_params().values()):
        assert torch.equal(p.detach(), q.detach()), n


def test_prefetcher_feeds_compile_multi_step_bitwise():
    _bitwise(*_prefetcher_vs_hand("cpu"))


@pytest.mark.cuda
def test_prefetcher_feeds_compile_multi_step_bitwise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with tmx.gpu():
        _bitwise(*_prefetcher_vs_hand("cuda"))


@pytest.mark.cuda
def test_staged_group_waits_for_its_copy():
    """Each group is 4 x 16 MB, staged while the previous group's replays
    keep the consumer's stream busy; every replay's result equals the one
    from a synchronous copy of the same host batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = onp.random.RandomState(0)
    host = [(rng.randn(2048, 2048).astype("float32"),) for _ in range(12)]
    with tmx.gpu():
        dev = torch.device("cuda")
        static = torch.zeros(2048, 2048, device=dev)
        w = torch.from_numpy(rng.randn(2048, 2048).astype("float32") /
                             45.0).to(dev)
        out = torch.zeros((), device=dev)

        def body():
            h = static
            for _ in range(8):
                h = torch.tanh(h @ w)
            out.copy_(h.sum())

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        want = []
        for (b,) in host:
            static.copy_(torch.from_numpy(b).to(dev))
            graph.replay()
            want.append(out.clone())
        got = []
        for (g,) in DevicePrefetcher(host, multi_step=4):
            for j in range(g.shape[0]):
                static.copy_(g._data[j])
                graph.replay()
                got.append(out.clone())
        torch.cuda.synchronize()
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_thread_of_the_prefetcher_is_not_the_callers():
    seen = []

    class Source:
        def __iter__(self):
            seen.append(threading.current_thread().name)
            yield (onp.zeros(2, "float32"),)

    list(DevicePrefetcher(Source()))
    assert seen == ["DevicePrefetcher"]
