"""Evaluation metrics (``mx.metric``).

Counterpart of ``mxnet_tpu/metric.py`` (reference: python/mxnet/gluon/
metric.py — EvalMetric:68, Accuracy:370, F1:727, Perplexity:1433, registry
create:195): the same 19 classes, ``create``, ``CustomMetric`` and
``np_metric``, with the same names, arguments and results.

``update`` takes NDArrays, tensors or numpy arrays, on either device. It
reduces on the prediction's own device (a label elsewhere is moved there),
sums in float64 (counts as integers) and moves only the scalars it adds to
the host, in one transfer an update. The reference calls ``.asnumpy()`` on
the whole prediction instead: for ``Perplexity`` at GPT-2 small's (4096,
50257) fp32 probabilities that is 823 MB a call, where the port moves two
float64 values. ``sum_metric`` and ``num_inst`` stay Python numbers, as
users read them. Differences from the reference's numpy arithmetic are in
the last bits of a float32 sum (numpy sums float32 in float32); counts and
the confusion matrix of ``PCC`` are exact in both.

Ties: ``Accuracy`` takes ``torch.argmax``, which returns the first maximal
index, as numpy's ``argmax`` does, so both packages agree. ``TopKAccuracy``
counts a hit when the label's rank in the row, sorted by descending score
with ties broken toward the lower index and NaN last, is below ``top_k``:
numpy's ``argsort(-pred, kind="stable")``. The reference calls the default
``argsort``, whose order among tied entries numpy leaves unspecified (its
SIMD quicksort is not stable even for 10-wide rows), so on ties the
reference's count depends on the machine; without ties the two agree.
``torch.topk`` leaves the order of ties unspecified too; the port does not
use it.

``CustomMetric`` (and ``np_metric``) hands its function numpy arrays, as
the reference does: a user's numpy code needs the host copy.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import MXNetError, Registry
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy", "Perplexity",
           "PearsonCorrelation", "Loss", "create", "BinaryAccuracy", "Fbeta",
           "MeanCosineSimilarity", "MeanPairwiseDistance", "PCC",
           "CustomMetric", "np_metric"]

_registry = Registry("metric")
register = _registry.register


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        m = CompositeEvalMetric()
        for child in metric:
            m.add(create(child, *args, **kwargs))
        return m
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    return _registry.get(metric)(*args, **kwargs)


def _tensor(x):
    """``x`` as a tensor where it lies: an NDArray's or a tensor's own data,
    array-like data on the host."""
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = onp.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(onp.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _pair(label, pred):
    """(label, pred) tensors on the prediction's device."""
    p = _tensor(pred)
    lab = _tensor(label)
    if lab.device != p.device:
        lab = lab.to(p.device)
    return lab, p


def _host(*values):
    """The 0-dim tensors ``values`` as Python floats, in one transfer."""
    return torch.stack([v.reshape(()).to(torch.float64)
                        for v in values]).tolist()


def _f64(t):
    return t.to(torch.float64)


def _np(x):
    """Host numpy of ``x`` (``CustomMetric``'s argument)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return onp.asarray(x)


def _picked(label, pred):
    """``pred[i, label[i]]`` on the device for (N, C) ``pred``, negative
    labels wrapped as numpy indexing wraps them; also whether a label lies
    outside [-C, C) (numpy raises there: the caller raises after its one
    transfer, having gathered a clamped index instead of faulting)."""
    c = pred.shape[-1]
    lab = label.reshape(-1).to(torch.int64)
    bad = ((lab < -c) | (lab >= c)).any()
    idx = torch.where(lab < 0, lab + c, lab).clamp(0, c - 1)
    return pred.gather(1, idx[:, None])[:, 0], bad


def _out_of_range(label, n):
    raise MXNetError(f"a label lies outside [-{n}, {n}): "
                     f"{tuple(label.shape)} labels for {n} classes")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        self.update(list(label.values()), list(pred.values()))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


_ARRAYS = (NDArray, onp.ndarray, torch.Tensor)


def _as_lists(labels, preds):
    if isinstance(labels, _ARRAYS):
        labels = [labels]
    if isinstance(preds, _ARRAYS):
        preds = [preds]
    if len(labels) != len(preds):
        raise MXNetError(f"labels/preds length mismatch "
                         f"{len(labels)} vs {len(preds)}")
    return labels, preds


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            if pred.dim() > label.dim():
                pred = pred.argmax(self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            label = label.to(torch.int32).reshape(-1)
            (hits,) = _host((pred == label).sum())
            self.sum_metric += hits
            self.num_inst += label.numel()


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            c = pred.shape[-1]
            lab = label.to(torch.int64)[..., None]
            inside = (lab >= 0) & (lab < c)
            at = pred.gather(-1, lab.clamp(0, c - 1).expand(
                *pred.shape[:-1], 1))
            before = torch.arange(c, device=pred.device) < lab
            nan = pred.isnan()
            # the label's place in the stable descending order, NaN last
            rank = torch.where(
                at.isnan(),
                (~nan).sum(-1, keepdim=True) + (nan & before).sum(
                    -1, keepdim=True),
                (pred > at).sum(-1, keepdim=True) + ((pred == at) & before)
                .sum(-1, keepdim=True))
            (hits,) = _host((inside & (rank < self.top_k)).sum())
            self.sum_metric += hits
            self.num_inst += label.numel()


def _binary(label, pred, threshold):
    """(predicted, true) boolean vectors: the score of class 1 of a
    two-column prediction, else the prediction, above ``threshold``."""
    label = label.reshape(-1).bool()
    if pred.dim() > 1 and pred.shape[-1] == 2:
        pred = pred[..., 1].reshape(-1) > threshold
    else:
        pred = pred.reshape(-1) > threshold
    return pred, label


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", threshold=0.5, **kwargs):
        self.average = average
        self.threshold = threshold
        self.beta = 1.0  # F1 is F-beta at beta=1 (Fbeta overrides)
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = 0.0

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _binary(*_pair(label, pred), self.threshold)
            tp, fp, fn = _host((pred & label).sum(), (pred & ~label).sum(),
                               (~pred & label).sum())
            self.tp += tp
            self.fp += fp
            self.fn += fn
            self.num_inst += 1

    def get(self):
        prec = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0
        rec = self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0
        b2 = self.beta * self.beta
        denom = b2 * prec + rec
        score = (1 + b2) * prec * rec / denom if denom else 0.0
        return self.name, score


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0.0

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred, label = _binary(*_pair(label, pred), 0.5)
            tp, fp, fn, tn = _host(
                (pred & label).sum(), (pred & ~label).sum(),
                (~pred & label).sum(), (~pred & ~label).sum())
            self.tp += tp
            self.fp += fp
            self.fn += fn
            self.tn += tn
            self.num_inst += 1

    def get(self):
        denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                          (self.tn + self.fp) * (self.tn + self.fn))
        mcc = ((self.tp * self.tn - self.fp * self.fn) / denom) if denom \
            else 0.0
        return self.name, mcc


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            (v,) = _host((_f64(label) - _f64(pred).reshape(label.shape))
                         .abs().mean())
            self.sum_metric += v
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            (v,) = _host(((_f64(label) - _f64(pred).reshape(label.shape))
                          ** 2).mean())
            self.sum_metric += v
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, float(onp.sqrt(value))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            prob, bad = _picked(label, pred)
            s, bad = _host((-torch.log(_f64(prob) + self.eps)).sum(), bad)
            if bad:
                _out_of_range(label, pred.shape[-1])
            self.sum_metric += s
            self.num_inst += prob.shape[0]


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            label = label.reshape(-1)
            prob, bad = _picked(label, pred.reshape(-1, pred.shape[-1]))
            nll = -torch.log(_f64(prob) + self.eps)
            if self.ignore_label is None:
                s, bad = _host(nll.sum(), bad)
                n = nll.numel()
            else:
                kept = label.to(torch.int64) != self.ignore_label
                s, n, bad = _host(torch.where(kept, nll, 0.0).sum(),
                                  kept.sum(), bad)
            if bad:
                _out_of_range(label, pred.shape[-1])
            self.sum_metric += s
            self.num_inst += int(n)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(onp.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r over everything updated so far: the raveled labels and
    predictions are kept on their device in float64 (as the reference keeps
    them on the host) and correlated at ``get``."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            self._labels.append(_f64(label).reshape(-1))
            self._preds.append(_f64(pred).reshape(-1))
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        dev = self._preds[0].device
        x = torch.cat([t.to(dev) for t in self._labels])
        y = torch.cat([t.to(dev) for t in self._preds])
        (r,) = _host(torch.corrcoef(torch.stack([x, y]))[0, 1])
        return self.name, r


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, _ARRAYS):
            preds = [preds]
        for pred in preds:
            loss = _tensor(pred)
            (s,) = _host(_f64(loss).sum())
            self.sum_metric += s
            self.num_inst += loss.numel()


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            val = self._feval(_np(label), _np(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np_metric(name=None, **kwargs):
    def decorator(f):
        return CustomMetric(f, name or f.__name__, **kwargs)

    return decorator


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of thresholded scores against 0/1 labels (reference:
    gluon/metric.py BinaryAccuracy)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            label = label.reshape(-1).bool()
            (hits,) = _host(((pred.reshape(-1) > self.threshold) == label)
                            .sum())
            self.sum_metric += hits
            self.num_inst += label.numel()


@register
class Fbeta(F1):
    """F-beta score: recall weighted ``beta``x against precision
    (reference: gluon/metric.py Fbeta); beta=1 reduces to F1."""

    def __init__(self, name="fbeta", beta=1.0, average="macro",
                 threshold=0.5, **kwargs):
        super().__init__(name=name, average=average, threshold=threshold,
                         **kwargs)
        self.beta = beta  # the shared F-beta formula lives on F1.get


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference:
    gluon/metric.py MeanCosineSimilarity)."""

    def __init__(self, name="cos_sim", eps=1e-12, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            a, b = map(_f64, _pair(label, pred))
            num = (a * b).sum(dim=-1)
            den = (a * a).sum(dim=-1).sqrt() * (b * b).sum(dim=-1).sqrt()
            sim = num / den.clamp_min(self.eps)
            (s,) = _host(sim.sum())
            self.sum_metric += s
            self.num_inst += sim.numel()


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between label/pred vectors (reference:
    gluon/metric.py MeanPairwiseDistance)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        self.p = p
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            a, b = map(_f64, _pair(label, pred))
            dist = ((a - b).abs() ** self.p).sum(dim=-1) ** (1.0 / self.p)
            (s,) = _host(dist.sum())
            self.sum_metric += s
            self.num_inst += dist.numel()


@register
class PCC(EvalMetric):
    """Multiclass Matthews/Pearson correlation from a running KxK
    confusion matrix (reference: gluon/metric.py PCC:1597). ``conf`` is a
    float64 tensor on the device of the predictions; its entries are
    counts, exact in float64."""

    def __init__(self, name="pcc", **kwargs):
        self.conf = torch.zeros((0, 0), dtype=torch.float64)
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self.conf = torch.zeros((0, 0), dtype=torch.float64)

    def _grow(self, k, device):
        old = self.conf.shape[0]
        if k > old or self.conf.device != device:
            new = torch.zeros((max(k, old),) * 2, dtype=torch.float64,
                              device=device)
            new[:old, :old] = self.conf
            self.conf = new

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _pair(label, pred)
            lab = label.reshape(-1).to(torch.int64)
            if pred.dim() > 1:
                pr = pred.argmax(-1).reshape(-1)
            elif pred.is_floating_point():
                pr = (pred.reshape(-1) > 0.5).to(torch.int64)  # like MCC
            else:
                pr = pred.reshape(-1).to(torch.int64)
            both = torch.cat([lab, pr, lab.new_zeros(1)])
            hi, lo = _host(both.max(), both.min())
            self._grow(int(hi) + 1, pred.device)
            k = self.conf.shape[0]
            if lo < -k:  # numpy's add.at wraps [-k, 0) and raises below
                raise MXNetError(f"PCC: class {int(lo)} outside [-{k}, {k})")
            self.conf.index_put_((lab % k, pr % k), torch.ones(
                (), dtype=torch.float64, device=pred.device),
                accumulate=True)
            self.num_inst += lab.numel()

    def get(self):
        c = self.conf
        if not c.numel():
            return self.name, 0.0
        n = c.sum()
        t = c.sum(dim=1)  # true counts per class
        p = c.sum(dim=0)  # predicted counts per class
        total, cov_tp, cov_tt, cov_pp = _host(
            n, torch.trace(c) * n - (t * p).sum(), n * n - (t * t).sum(),
            n * n - (p * p).sum())
        if total == 0:
            return self.name, 0.0
        denom = math.sqrt(cov_tt * cov_pp)
        return self.name, float(cov_tp / denom) if denom else 0.0
