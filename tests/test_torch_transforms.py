"""PyTorch/CUDA port: ``gluon.data.vision.transforms`` against the JAX
package's.

Every transform, applied to the same seeded uint8 images after the same
``mx.random.seed`` in both packages (the random ones draw from
``mx.random.host_rng``, seeded alike), gives the JAX package's output
bitwise, several draws in a row; so do ``Compose`` pipelines inside a
serial ``DataLoader`` (``transform_first``). A spawned worker's
``host_rng`` starts at ``RandomState(0)`` whatever the parent's seed, as the
reference's does (ROADMAP C): its draws are not held against the JAX
package. Tolerance: none, bitwise.
"""
import numpy as onp
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.data import DataLoader, SimpleDataset
from mxnet_tpu_torch.gluon.data.vision import transforms as tT


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _jax():
    import mxnet_tpu as jmx

    return jmx


def _cases(T):
    return {
        "Cast": T.Cast("float32"),
        "ToTensor": T.ToTensor(),
        "Normalize": T.Compose([T.ToTensor(),
                                T.Normalize((0.4, 0.5, 0.6),
                                            (0.2, 0.25, 0.3))]),
        "Resize": T.Resize((7, 5)),
        "CenterCrop": T.CenterCrop(9),
        "RandomResizedCrop": T.RandomResizedCrop(8),
        "RandomCrop": T.RandomCrop((6, 10), pad=2),
        "RandomFlipLeftRight": T.RandomFlipLeftRight(),
        "RandomFlipTopBottom": T.RandomFlipTopBottom(),
        "RandomBrightness": T.RandomBrightness(0.4),
        "RandomContrast": T.RandomContrast(0.4),
        "RandomSaturation": T.RandomSaturation(0.4),
        "RandomLighting": T.RandomLighting(0.3),
        "RandomApply": T.RandomApply([T.RandomFlipLeftRight(),
                                      T.RandomBrightness(0.2)], p=0.6),
        "HybridRandomApply": T.HybridRandomApply(T.CenterCrop(4), p=0.3),
        "HybridCompose": T.HybridCompose([T.RandomCrop(12),
                                          T.RandomFlipTopBottom(),
                                          T.ToTensor()]),
    }


def _images(n=6):
    rng = onp.random.RandomState(8)
    return [rng.randint(0, 256, (16, 14, 3)).astype("uint8")
            for _ in range(n)]


def _run(pkg, T, name, seed):
    pkg.random.seed(seed)
    t = _cases(T)[name]
    out = []
    for img in _images():
        y = t(img)
        out.append(y.asnumpy() if hasattr(y, "asnumpy") else onp.asarray(y))
    return out


@pytest.mark.parametrize("name", sorted(_cases(tT)))
def test_transform_matches_jax(name):
    from mxnet_tpu.gluon.data.vision import transforms as jT

    for seed in (0, 17):
        got = _run(tmx, tT, name, seed)
        want = _run(_jax(), jT, name, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert onp.array_equal(a, b)


def test_transform_passes_extra_arguments():
    img = _images(1)[0]
    out, label = tT.ToTensor()(img, 3)
    assert out.shape == (3, 16, 14) and label == 3


def _loader_batches(pkg, T, data):
    pkg.random.seed(5)
    ds = data.SimpleDataset([(im, i) for i, im in enumerate(_images())])
    pipe = T.Compose([T.RandomResizedCrop(10), T.RandomFlipLeftRight(),
                      T.ToTensor(), T.Normalize(0.5, 0.25)])
    loader = data.DataLoader(ds.transform_first(pipe), batch_size=4)
    return [tuple(v.asnumpy() for v in b) for b in loader]


def test_pipeline_in_a_loader_matches_jax():
    from mxnet_tpu.gluon import data as jdata
    from mxnet_tpu.gluon.data.vision import transforms as jT
    from mxnet_tpu_torch.gluon import data as tdata

    got = _loader_batches(tmx, tT, tdata)
    want = _loader_batches(_jax(), jT, jdata)
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and onp.array_equal(u, v)


def test_spawned_worker_host_rng_starts_at_zero():
    """The worker unpickles ``_draw`` by importing this module."""
    tmx.random.seed(1234)
    ds = SimpleDataset([0] * 2).transform(_draw)
    (batch,) = list(DataLoader(ds, batch_size=2, num_workers=1))
    want = onp.random.RandomState(0).randint(0, 2 ** 30, 2)
    assert list(batch.asnumpy()) == list(want)


def _draw(_):
    from mxnet_tpu_torch import random

    return int(random.host_rng.randint(0, 2 ** 30))
