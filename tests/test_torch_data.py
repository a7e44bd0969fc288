"""PyTorch/CUDA port: ``gluon.data`` against the JAX package's.

- Datasets and their lazy views (``shard``, ``take``, ``sample``,
  ``filter``, ``transform``, ``transform_first``), the samplers (the same
  permutation from one seed) and the batchify functions give the JAX
  package's samples, values and dtypes.
- The DataLoader's three worker models (serial, ``thread_pool=True``,
  spawned processes) give the JAX package's serial batches bitwise: values,
  shapes and the 32-bit dtypes of 64-bit data, under every ``last_batch``.
- The reference's ``tests/test_dataloader_mp.py`` cases: a worker's error
  reaches the caller, an unpicklable dataset raises naming
  ``thread_pool=True``, two concurrent iterators each get all their batches,
  the work runs in other processes. A pool starts without waiting for its
  workers' imports. Spawned workers see no GPU
  (``CUDA_VISIBLE_DEVICES=""``), initialise no CUDA and make their arrays
  on the CPU; no shared-memory segment is left behind after an early
  break.
- A thread worker under ``with mx.cpu():`` makes its NDArrays on the
  caller's device (a context scope is per thread); without a scope and
  without a GPU, ``iter(loader)`` raises.
- ``vision``: the synthetic MNIST, FashionMNIST, CIFAR-10 and CIFAR-100
  bitwise equal to the JAX package's; idx files (plain and gz), CIFAR
  batches and an ``ImageFolderDataset`` of ``.npy`` files read the same,
  and so do ``RecordFileDataset``, ``ImageRecordDataset`` and
  ``ImageListDataset`` over one file of the reference's
  (``tests/test_torch_image.py`` holds the rest of the image pipeline).
- ``tests/torch_script_mnist.py`` (``examples/gluon_mnist.py`` with its
  imports changed) trains one epoch on the CPU with two spawned workers.
- On the card (``cuda``-marked): ``pin_memory=True`` batches, serial and
  from processes, land on the GPU equal to the CPU's.

Tolerance: none; every comparison is bitwise.
"""
import gzip
import os
import pickle
import struct
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data import DataLoader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_data_workers as workers  # noqa: E402


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _jdata():
    from mxnet_tpu.gluon import data as jdata

    return jdata


def _host(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


def _same(a, b):
    a, b = _host(a), _host(b)
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
        return
    if isinstance(a, onp.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        assert onp.array_equal(a, b, equal_nan=True)
        return
    assert a == b


def _arrays(n=21):
    rng = onp.random.RandomState(0)
    return rng.randn(n, 3, 2), onp.arange(n)          # float64, int64


# -- datasets and views ----------------------------------------------------------
def _views(data):
    x, y = _arrays()
    ds = data.ArrayDataset(x, y)
    return {
        "array": ds,
        "one_array": data.ArrayDataset(x),
        "simple": data.SimpleDataset(list(range(10))),
        "shard": ds.shard(4, 1),
        "take": ds.take(5),
        "sample": ds.sample(data.SequentialSampler(6, start=3)),
        "filter": ds.filter(lambda s: s[1] % 3 == 0),
        "transform": ds.transform(lambda s: (s[0] * 2, s[1] + 1)),
        "transform_first": ds.transform_first(lambda a: a.sum(-1)),
        "eager": ds.transform(lambda s: (s[0] + 1, s[1]), lazy=False),
    }


def test_datasets_and_views_match_jax():
    mine, ref = _views(tdata), _views(_jdata())
    for name in mine:
        assert len(mine[name]) == len(ref[name]), name
        for i in range(len(ref[name])):
            _same(mine[name][i], ref[name][i])
    with pytest.raises(MXNetError):
        tdata.ArrayDataset(onp.zeros(3), onp.zeros(4))
    with pytest.raises(MXNetError):
        tdata.ArrayDataset()
    with pytest.raises(MXNetError, match="out of range"):
        tdata.SimpleDataset([1]).shard(2, 2)
    # transform_first's wrapper pickles, so the view can go to a worker
    view = tdata.ArrayDataset(*_arrays()).transform_first(onp.negative)
    _same(pickle.loads(pickle.dumps(view))[3], view[3])


def test_record_file_datasets_are_not_ported(tmp_path):
    """Ported since: the three RecordIO datasets give the JAX package's
    samples from one file, written by the reference's ``recordio``."""
    from mxnet_tpu import recordio as jrio
    from mxnet_tpu_torch.gluon.data import vision
    from PIL import Image

    jv = _jdata().vision
    rs = onp.random.RandomState(1)
    rec = jrio.MXIndexedRecordIO(str(tmp_path / "x.idx"),
                                 str(tmp_path / "x.rec"), "w")
    for i in range(4):
        img = rs.randint(0, 256, (9 + i, 11, 3)).astype("uint8")
        rec.write_idx(i, jrio.pack_img(jrio.IRHeader(0, float(i), i), img,
                                       img_fmt=".png"))
        Image.fromarray(img).save(str(tmp_path / f"{i}.png"))
    rec.close()
    path = str(tmp_path / "x.rec")
    imglist = [[float(i), f"{i}.png"] for i in range(4)]
    for got, want in ((tdata.RecordFileDataset(path),
                       _jdata().RecordFileDataset(path)),
                      (vision.ImageRecordDataset(path),
                       jv.ImageRecordDataset(path)),
                      (vision.ImageListDataset(str(tmp_path), imglist),
                       jv.ImageListDataset(str(tmp_path), imglist))):
        assert len(got) == len(want) == 4
        for i in range(4):
            _same(got[i], want[i])


# -- samplers -----------------------------------------------------------------------
def _samplers(data, seed):
    ds = data.SimpleDataset(list(range(17)))
    return {
        "sequential": data.SequentialSampler(9, start=2),
        "random": data.RandomSampler(17, rng=seed),
        "random_gen": data.RandomSampler(
            17, rng=onp.random.default_rng(seed + 1)),
        "interval": data.IntervalSampler(17, 5),
        "interval_once": data.IntervalSampler(17, 5, rollover=False),
        "filter": data.FilterSampler(lambda s: s % 2, ds),
        "batch_keep": data.BatchSampler(data.SequentialSampler(17), 5),
        "batch_discard": data.BatchSampler(data.SequentialSampler(17), 5,
                                           "discard"),
        "batch_rollover": data.BatchSampler(
            data.RandomSampler(17, rng=seed), 5, "rollover"),
    }


def test_samplers_match_jax():
    mine, ref = _samplers(tdata, 11), _samplers(_jdata(), 11)
    for name in ref:
        for _ in range(3):   # epochs: new permutations, rollover carried
            assert len(mine[name]) == len(ref[name]), name
            assert list(mine[name]) == list(ref[name]), name
    with pytest.raises(ValueError):
        tdata.BatchSampler(tdata.SequentialSampler(3), 2, "nope")
    with pytest.raises(ValueError):
        tdata.IntervalSampler(3, 4)


# -- batchify -----------------------------------------------------------------------
def _batchify_cases(data):
    b = data.batchify
    rng = onp.random.RandomState(2)
    ragged = [rng.randn(n, 3).astype("float32") for n in (2, 5, 3)]
    pairs = [(rng.randn(4), int(i)) for i in range(3)]
    return [
        (b.Stack(), [rng.randn(2, 3) for _ in range(4)]),
        (b.Stack(), pairs),
        (b.Pad(), ragged),
        (b.Pad(axis=0, pad_val=-1, ret_length=True), ragged),
        (b.Pad(val=7, dtype="int32", round_to=4), ragged),
        (b.Tuple(b.Stack(), b.Pad()), [(p, r) for p, r in
                                       zip([x[0] for x in pairs], ragged)]),
        (b.Group([b.Stack(), b.Stack()]), pairs),
    ]


def test_batchify_matches_jax():
    for (fn, samples), (jfn, jsamples) in zip(_batchify_cases(tdata),
                                              _batchify_cases(_jdata())):
        _same(fn(samples), jfn(jsamples))
    with pytest.raises(MXNetError, match="fields"):
        tdata.batchify.Tuple(tdata.batchify.Stack())([(1, 2)])
    with pytest.raises(MXNetError, match="rank"):
        tdata.batchify.Pad()([onp.zeros(2), onp.zeros((2, 2))])


# -- the DataLoader's three worker models -------------------------------------------
LOADER_CASES = [dict(batch_size=4), dict(batch_size=4, last_batch="discard"),
                dict(batch_size=5, last_batch="rollover"),
                dict(batch_size=6, sampler="random")]


def _loader(data, kw, **more):
    kw = dict(kw)
    x, y = _arrays()
    if kw.get("sampler") == "random":
        kw["sampler"] = data.RandomSampler(len(x), rng=5)
    return data.DataLoader(data.ArrayDataset(x, y), **kw, **more)


def _epochs(loader, n=2):
    return [[_host(b) for b in loader] for _ in range(n)]


@pytest.mark.parametrize("model", ["serial", "threads"])
def test_loader_matches_jax_serial(model):
    more = {} if model == "serial" else dict(num_workers=3,
                                             thread_pool=True)
    for kw in LOADER_CASES:
        got = _epochs(_loader(tdata, kw, **more))
        want = _epochs(_loader(_jdata(), kw))
        _same(got, want)
        assert got[0][0][0].dtype == onp.float32
        assert got[0][0][1].dtype == onp.int32


def test_process_workers_match_jax_serial():
    """One pool, reused across the epochs (a new permutation each)."""
    kw = LOADER_CASES[3]
    loader = _loader(tdata, kw, num_workers=2)
    assert len(loader) == 4
    got = _epochs(loader, 3)
    _same(got, _epochs(_loader(_jdata(), kw), 3))
    assert all(isinstance(b[0], tmx.NDArray) and b[0].ctx == tmx.cpu()
               for b in loader)


def test_worker_start_does_not_wait_for_imports():
    """The pickled dataset (here 4 MB, more than a pipe holds) goes to the
    workers through a queue: ``Process.start()`` returns at once instead of
    waiting until the child has imported torch and read its arguments."""
    x = onp.zeros((1 << 20,), "float32")
    loader = DataLoader(tdata.ArrayDataset(x), batch_size=4, num_workers=1)
    t0 = time.perf_counter()
    loader._ensure_pool()
    started = time.perf_counter() - t0
    it = iter(loader)
    assert next(it).shape == (4,)
    first = time.perf_counter() - t0
    it.close()
    assert started < 0.5 * first, (started, first)


def test_process_worker_error_propagates():
    import operator

    ds = tdata.SimpleDataset([1.0, 2.0]).transform(operator.itemgetter(3))
    with pytest.raises(MXNetError, match="worker failed"):
        list(DataLoader(ds, batch_size=2, num_workers=1))


def test_unpicklable_dataset_raises_helpfully():
    ds = tdata.SimpleDataset([1.0, 2.0]).transform(lambda s: s)
    with pytest.raises(MXNetError, match="thread_pool=True"):
        list(DataLoader(ds, batch_size=2, num_workers=1))


def _shm_names():
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}
    except FileNotFoundError:
        return set()


def _leaked(before, polls=4):
    """Segments that appeared since ``before`` and stay through ``polls``
    looks 0.25 s apart (other test processes' segments come and go)."""
    kept = _shm_names() - before
    for _ in range(polls):
        if not kept:
            break
        time.sleep(0.25)
        kept &= _shm_names()
    return kept


def test_two_concurrent_iterators_and_no_shm_leak():
    """An older live iterator routes (does not unlink) a newer iterator's
    batches; both see complete, correct data. Breaking out early and
    dropping the loader leaves no shared-memory segment behind."""
    import gc

    before = _shm_names()
    x, y = _arrays(48)
    ds = tdata.ArrayDataset(x.astype("float32"), y)
    dl = DataLoader(ds, batch_size=8, num_workers=2)
    it1 = iter(dl)
    first = next(it1)[0].asnumpy()
    all2 = [b[0].asnumpy() for b in iter(dl)]
    rest1 = [b[0].asnumpy() for b in it1]
    want = [b[0].asnumpy() for b in DataLoader(ds, batch_size=8)]
    assert len(all2) == 6 and len(rest1) == 5
    for a, b in zip(all2, want):
        assert (a == b).all()
    for a, b in zip([first] + rest1, want):
        assert (a == b).all()
    it3 = iter(dl)
    next(it3)          # the pool has more batches in flight
    it3.close()
    del dl, it1, it3
    gc.collect()
    assert not _leaked(before)


def test_workers_are_other_processes_without_a_gpu(tmp_path):
    marker = str(tmp_path / "pids")
    ds = tdata.SimpleDataset([marker] * 8).transform(workers.record_pid)
    out = list(DataLoader(ds, batch_size=4, num_workers=2))
    assert len(out) == 2
    pids = {int(line) for line in open(marker).read().split()}
    assert os.getpid() not in pids and pids
    reports = [r for b in DataLoader(workers.WorkerReport(8),
                                     batch_size=1, num_workers=2,
                                     batchify_fn=list)
               for r in b]
    assert {r[0] for r in reports} - {os.getpid()}
    for pid, cuda_init, visible, count, where in reports:
        assert pid != os.getpid()
        assert (cuda_init, visible, count, where) == (False, "", 0, "cpu")
    assert os.environ.get("CUDA_VISIBLE_DEVICES") != "" or \
        "CUDA_VISIBLE_DEVICES" not in os.environ


def test_thread_workers_see_the_callers_context():
    """A batchify function that makes NDArrays runs in the worker threads;
    they make them on the caller's device. Without a scope (a fresh thread
    on this GPU-less machine) iterating raises instead of choosing."""
    x, y = _arrays()
    loader = DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                        num_workers=3, thread_pool=True,
                        batchify_fn=tdata.default_batchify_fn)
    got = list(loader)
    assert all(b[0].ctx == tmx.cpu() for b in got)
    _same(got, list(_loader(_jdata(), LOADER_CASES[0])))
    if torch.cuda.is_available():
        return
    errors = []

    def no_scope():
        try:
            iter(loader)
        except MXNetError as e:
            errors.append(str(e))

    t = threading.Thread(target=no_scope)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and errors and "GPU is required" in errors[0]


def test_loader_records_telemetry():
    from mxnet_tpu_torch import telemetry

    n0 = telemetry.counter("dataloader.batches").value
    t0 = telemetry.timer("dataloader.batch").count
    list(_loader(tdata, LOADER_CASES[0]))
    assert telemetry.counter("dataloader.batches").value - n0 == 6
    assert telemetry.timer("dataloader.batch").count - t0 == 6


# -- vision datasets ------------------------------------------------------------------
SYNTHETIC = [("MNIST", True), ("MNIST", False), ("FashionMNIST", False),
             ("CIFAR10", False), ("CIFAR100", False)]


@pytest.mark.parametrize("name,train", SYNTHETIC)
def test_synthetic_vision_sets_match_jax(name, train, tmp_path):
    from mxnet_tpu.gluon.data import vision as jvision
    from mxnet_tpu_torch.gluon.data import vision as tvision

    root = str(tmp_path / "none")
    mine = getattr(tvision, name)(root=root, train=train)
    ref = getattr(jvision, name)(root=root, train=train)
    assert mine.synthetic and ref.synthetic and len(mine) == len(ref)
    _same(mine._data, ref._data)
    _same(mine._label, ref._label)
    _same(mine[7], ref[7])


def _write_idx(root, gz, n=6):
    rng = onp.random.RandomState(9)
    img = rng.randint(0, 256, (n, 28, 28)).astype("uint8")
    lbl = rng.randint(0, 10, n).astype("uint8")
    opener = gzip.open if gz else open
    ext = ".gz" if gz else ""
    os.makedirs(root, exist_ok=True)
    with opener(os.path.join(root, "t10k-images-idx3-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with opener(os.path.join(root, "t10k-labels-idx1-ubyte" + ext),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbl.tobytes())


def test_vision_files_read_as_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jvision
    from mxnet_tpu_torch.gluon.data import vision as tvision

    for gz in (False, True):
        root = str(tmp_path / f"mnist{gz}")
        _write_idx(root, gz)
        mine = tvision.MNIST(root=root, train=False)
        ref = jvision.MNIST(root=root, train=False)
        assert not mine.synthetic and len(mine) == 6
        for i in range(6):
            _same(mine[i], ref[i])
    cifar = tmp_path / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    rng = onp.random.RandomState(4)
    with open(cifar / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (5, 3072)).astype("uint8"),
                     b"labels": [1, 2, 3, 4, 5]}, f)
    mine = tvision.CIFAR10(root=str(tmp_path / "cifar"), train=False)
    ref = jvision.CIFAR10(root=str(tmp_path / "cifar"), train=False)
    assert not mine.synthetic
    for i in range(5):
        _same(mine[i], ref[i])
    folder = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        (folder / cls).mkdir(parents=True)
        for k in range(2):
            onp.save(folder / cls / f"{k}.npy",
                     onp.full((4, 4, 3), 10 * c + k, "uint8"))
    (folder / "notes.txt").write_text("not a class")
    mine = tvision.ImageFolderDataset(str(folder),
                                      transform=lambda x, y: (x + 1, y))
    ref = jvision.ImageFolderDataset(str(folder),
                                     transform=lambda x, y: (x + 1, y))
    assert mine.synsets == ref.synsets == ["cat", "dog"]
    assert len(mine) == len(ref) == 4
    for i in range(4):
        _same(mine[i], ref[i])


def test_mnist_script_trains_on_the_cpu(tmp_path):
    """``examples/gluon_mnist.py``'s body, imports changed: one epoch on the
    synthetic set with two spawned workers; the loss falls below its
    first batches' and validation accuracy reaches 0.9."""
    import torch_script_mnist as script

    hist = script.main(["--epochs", "1", "--params",
                        str(tmp_path / "mlp.params.npz")], ctx=tmx.cpu())
    (loss, acc, _), = hist
    assert onp.isfinite(loss) and loss < 2.3 and acc >= 0.9
    assert (tmp_path / "mlp.params.npz").exists()


# -- on the card -------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("workers_", [0, 2])
def test_pin_memory_lands_on_the_gpu(workers_):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, y = _arrays(40)
    ds = tdata.ArrayDataset(x, y)
    want = [_host(b) for b in DataLoader(ds, batch_size=8)]
    with tmx.gpu():
        got = list(DataLoader(ds, batch_size=8, pin_memory=True,
                              num_workers=workers_))
        torch.cuda.synchronize()
    assert all(b[0]._data.is_cuda and b[1]._data.is_cuda for b in got)
    _same([_host(b) for b in got], want)
