"""PyTorch/CUDA port: ``mx.metric`` against the JAX package's.

- The reference's metric cases (``tests/test_loss_metric.py``) run in both
  packages, each on its own arrays.
- Every one of the 19 classes, fed the same seeded numpy inputs in two
  updates (the port's as NDArrays on the CPU, the JAX package's as numpy),
  gives the same ``get()``; ``Perplexity`` with and without
  ``ignore_label``; ``create`` by name, list, callable and instance, and
  ``CompositeEvalMetric``.
- Ties: ``Accuracy``'s argmax equals the reference's; ``TopKAccuracy``
  on tied scores (and NaN) follows the stable order, held to the
  reference's formula with numpy's stable argsort (numpy's default leaves
  tied entries in no specified order).
- The port reduces where the prediction lies and moves only scalars: a
  label out of range raises ``MXNetError`` instead of a device fault.
- On the card (``cuda``-marked), every class updated with tensors on the
  GPU gives the CPU's value.

Tolerance: 1e-6 relative (the port sums in float64 where numpy sums float32
in float32); counts, accuracies and the confusion matrix are exact.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, metric as tmetric

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _jax():
    import mxnet_tpu as jmx

    return jmx


def _pkg(name):
    return _jax() if name == "jax" else tmx


# -- the reference's cases, in both packages ----------------------------------
def _ref_accuracy(mx):
    np, metric = mx.np, mx.metric
    m = metric.Accuracy()
    m.update(np.array([0, 1, 1]), np.array([[0.9, 0.1], [0.2, 0.8],
                                            [0.7, 0.3]]))
    assert abs(m.get()[1] - 2.0 / 3) < 1e-6


def _ref_topk(mx):
    m = mx.metric.TopKAccuracy(top_k=2)
    m.update(mx.np.array([2]), mx.np.array([[0.3, 0.1, 0.2]]))
    assert m.get()[1] == 1.0


def _ref_f1_mcc(mx):
    np, metric = mx.np, mx.metric
    m = metric.F1()
    m.update(np.array([1, 0, 1, 1]), np.array([0.9, 0.2, 0.8, 0.1]))
    assert 0 < m.get()[1] <= 1
    mcc = metric.MCC()
    mcc.update(np.array([1, 0, 1, 1]), np.array([0.9, 0.2, 0.8, 0.1]))
    assert -1 <= mcc.get()[1] <= 1


def _ref_mae_mse_rmse(mx):
    np, metric = mx.np, mx.metric
    label, pred = np.array([1.0, 2.0]), np.array([1.5, 2.5])
    for cls, want in ((metric.MAE, 0.5), (metric.MSE, 0.25),
                      (metric.RMSE, 0.5)):
        m = cls()
        m.update(label, pred)
        assert abs(m.get()[1] - want) < 1e-6


def _ref_perplexity(mx):
    m = mx.metric.Perplexity()
    m.update(mx.np.array([0]), mx.np.array([[1.0, 0.0]]))
    assert abs(m.get()[1] - 1.0) < 1e-4


def _ref_composite(mx):
    m = mx.metric.create(["mse", "mae"])
    m.update(mx.np.array([1.0, 2.0]), mx.np.array([1.5, 2.5]))
    names, values = m.get()
    assert len(names) == 2 and values == [0.25, 0.5]


def _ref_custom(mx):
    m = mx.metric.create(lambda label, pred: float(onp.sum(label == pred)))
    m.update(mx.np.array([1, 2]), mx.np.array([1, 3]))
    assert m.get()[1] == 1.0


def _ref_extended(mx):
    np, metric = mx.np, mx.metric
    ba = metric.BinaryAccuracy(threshold=0.5)
    ba.update(np.array([1, 0, 1, 0]), np.array([0.9, 0.2, 0.3, 0.1]))
    assert ba.get()[1] == 0.75
    fb = metric.Fbeta(beta=2.0)
    fb.update(np.array([1, 0, 0]), np.array([0.9, 0.8, 0.7]))
    assert abs(fb.get()[1] - 5.0 / 7.0) < 1e-6
    f1c = metric.F1()
    f1c.update(np.array([1, 0, 0]), np.array([0.9, 0.8, 0.7]))
    assert abs(f1c.get()[1] - 0.5) < 1e-6
    cs = metric.MeanCosineSimilarity()
    cs.update(np.array([[1.0, 0.0]]), np.array([[1.0, 0.0]]))
    cs.update(np.array([[1.0, 0.0]]), np.array([[0.0, 1.0]]))
    assert abs(cs.get()[1] - 0.5) < 1e-6
    mpd = metric.MeanPairwiseDistance()
    mpd.update(np.array([[0.0, 0.0]]), np.array([[3.0, 4.0]]))
    assert abs(mpd.get()[1] - 5.0) < 1e-6
    pcc = metric.PCC()
    pcc.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1]))
    assert abs(pcc.get()[1] - 1.0) < 1e-6
    pcc.reset()
    lab = onp.array([1, 1, 0, 0, 1, 0, 1, 0])
    pr = onp.array([1, 0, 0, 1, 1, 0, 0, 0])
    pcc.update(np.array(lab), np.array(pr.astype("float64") * 0.9 + 0.05))
    mcc = metric.MCC()
    scores = onp.stack([1.0 - pr, pr.astype("float64")], axis=1)
    mcc.update(np.array(lab), np.array(scores))
    assert abs(pcc.get()[1] - mcc.get()[1]) < 1e-6
    assert metric.create("pcc").get()[0] == "pcc"


REF_CASES = {"accuracy": _ref_accuracy, "topk": _ref_topk,
             "f1_mcc": _ref_f1_mcc, "mae_mse_rmse": _ref_mae_mse_rmse,
             "perplexity": _ref_perplexity, "composite": _ref_composite,
             "custom": _ref_custom, "extended": _ref_extended}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_reference_metric_cases(case, pkg):
    REF_CASES[case](_pkg(pkg))


# -- every class against the JAX package on seeded inputs ---------------------
def _probs(rng, n, c):
    p = rng.rand(n, c).astype("float32") + 0.05
    return (p / p.sum(-1, keepdims=True)).astype("float32")


def _inputs(name, rng):
    """Two (label, pred) updates of seeded numpy inputs for ``name``."""
    out = []
    for n in (37, 23):
        if name in ("Accuracy", "TopKAccuracy", "CrossEntropy", "PCC"):
            out.append((rng.randint(0, 7, n).astype("int32"),
                        _probs(rng, n, 7)))
        elif name == "Perplexity":
            out.append((rng.randint(0, 11, (n, 3)).astype("float32"),
                        _probs(rng, 3 * n, 11).reshape(n, 3, 11)))
        elif name in ("F1", "Fbeta", "MCC", "BinaryAccuracy"):
            out.append((rng.randint(0, 2, n).astype("float32"),
                        rng.rand(n, 2).astype("float32")
                        if n == 37 and name != "BinaryAccuracy" else
                        rng.rand(n).astype("float32")))
        elif name in ("MeanCosineSimilarity", "MeanPairwiseDistance"):
            out.append((rng.randn(n, 5).astype("float32"),
                        rng.randn(n, 5).astype("float32")))
        else:
            out.append((rng.randn(n, 3).astype("float32"),
                        rng.randn(n, 3).astype("float32")))
    return out


def _custom_fn(label, pred):
    return float(onp.abs(label - pred).sum()), int(label.size)


def _make(metric, name):
    kw = {"TopKAccuracy": dict(top_k=3), "Fbeta": dict(beta=2.0),
          "MeanPairwiseDistance": dict(p=3),
          "F1": dict(threshold=0.4)}.get(name, {})
    if name == "CustomMetric":
        return metric.CustomMetric(_custom_fn, name="l1")
    if name == "CompositeEvalMetric":
        return metric.CompositeEvalMetric(["mse", "mae", metric.RMSE()])
    if name == "PerplexityIgnore":
        return metric.Perplexity(ignore_label=3)
    return getattr(metric, name)(**kw)


CLASSES = ["Accuracy", "TopKAccuracy", "F1", "MCC", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "PerplexityIgnore",
           "PearsonCorrelation", "Loss", "BinaryAccuracy", "Fbeta",
           "MeanCosineSimilarity", "MeanPairwiseDistance", "PCC",
           "CustomMetric", "CompositeEvalMetric"]


def _close(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert abs(got - want) <= RTOL * max(abs(want), 1e-12), (got, want)


@pytest.mark.parametrize("name", CLASSES)
def test_every_metric_matches_jax(name):
    jmetric = _jax().metric
    data = _inputs(name.replace("Ignore", ""), onp.random.RandomState(3))
    mine, ref = _make(tmetric, name), _make(jmetric, name)
    for label, pred in data:
        mine.update(tmx.np.array(label), tmx.np.array(pred))
        ref.update(label, pred)
    (n1, v1), (n2, v2) = mine.get(), ref.get()
    assert n1 == n2
    _close(v1, v2)
    assert mine.num_inst == ref.num_inst if name != "CompositeEvalMetric" \
        else True
    mine.reset()
    ref.reset()
    assert mine.get_name_value() == ref.get_name_value() or \
        all(onp.isnan(v) for _, v in mine.get_name_value())


def test_base_metric_and_registry():
    m = tmetric.EvalMetric("x")
    assert m.get()[0] == "x" and onp.isnan(m.get()[1])
    with pytest.raises(NotImplementedError):
        m.update([1], [1])
    assert set(tmetric._registry.list()) == set(_jax().metric._registry
                                                .list())
    acc = tmetric.Accuracy()
    assert tmetric.create(acc) is acc
    assert isinstance(tmetric.create("Perplexity", ignore_label=0),
                      tmetric.Perplexity)
    with pytest.raises(KeyError):
        tmetric.create("no-such-metric")

    @tmetric.np_metric(name="hits")
    def hits(label, pred):
        return float((label == pred.argmax(-1)).sum()), label.size

    hits.update(tmx.np.array([1, 0]), tmx.np.array([[0.0, 1.0],
                                                    [0.0, 1.0]]))
    assert hits.name == "custom(hits)" and hits.get()[1] == 0.5
    comp = tmetric.create([tmetric.Accuracy(), "f1"])
    comp.update_dict({"y": tmx.np.array([1, 0])},
                     {"p": tmx.np.array([[0.0, 1.0], [1.0, 0.0]])})
    assert comp.get() == (["accuracy", "f1"], [1.0, 1.0])
    assert "accuracy" in str(tmetric.Accuracy())


def _topk_stable(label, pred, top_k):
    """The reference's TopKAccuracy formula with numpy's stable argsort."""
    idx = onp.argsort(-pred, axis=-1, kind="stable")[..., :top_k]
    return float((idx == label[..., None].astype("int64")).any(-1).sum())


def test_ties():
    """Accuracy's argmax takes the first maximal index in both packages.
    numpy's default argsort leaves tied entries in no specified order (its
    SIMD quicksort is not stable even for 10-wide rows), so the reference's
    TopKAccuracy on ties depends on the machine; the port's is the stable
    order, held to the reference's formula with ``kind="stable"``. Without
    ties both packages agree (``test_every_metric_matches_jax``)."""
    jmetric = _jax().metric
    rng = onp.random.RandomState(5)
    pred = rng.randint(0, 3, (64, 10)).astype("float32")   # many ties
    pred[0, :] = onp.nan
    pred[1, 3] = onp.nan
    label = rng.randint(0, 10, 64).astype("int32")
    label[:2] = 3
    for top_k in (1, 2, 3, 5):
        mine = tmetric.TopKAccuracy(top_k=top_k)
        mine.update(tmx.np.array(label), tmx.np.array(pred))
        assert mine.sum_metric == _topk_stable(label, pred, top_k), top_k
    mine, ref = tmetric.Accuracy(), jmetric.Accuracy()
    mine.update(torch.from_numpy(label[2:]), torch.from_numpy(pred[2:]))
    ref.update(label[2:], pred[2:])
    assert mine.get() == ref.get()
    # numpy inputs reduce on the host as they are
    mine = tmetric.TopKAccuracy(top_k=2)
    mine.update(label, pred)
    assert mine.sum_metric == _topk_stable(label, pred, 2)


def test_out_of_range_label_raises():
    pred = tmx.np.array(onp.full((2, 3), 1 / 3, "float32"))
    for cls in (tmetric.CrossEntropy, tmetric.Perplexity):
        with pytest.raises(MXNetError, match="outside"):
            cls().update(tmx.np.array([0, 3]), pred)
    # negative labels wrap as numpy indexing wraps them
    m = tmetric.CrossEntropy()
    m.update(tmx.np.array([-1, 0]), pred)
    assert abs(m.get()[1] - onp.log(3.0)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", CLASSES)
def test_device_update_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _inputs(name.replace("Ignore", ""), onp.random.RandomState(4))
    on_gpu, on_cpu = _make(tmetric, name), _make(tmetric, name)
    for label, pred in data:
        on_gpu.update(torch.from_numpy(label).cuda(),
                      torch.from_numpy(pred).cuda())
        on_cpu.update(torch.from_numpy(label), torch.from_numpy(pred))
    _close(on_gpu.get()[1], on_cpu.get()[1])
