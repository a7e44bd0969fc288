"""Loss blocks (the subset the GPT training path uses).

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base with
``_mean_nonbatch`` and ``_apply_weighting`` (:16-40), ``L2Loss`` (:41) and
``SoftmaxCrossEntropyLoss`` / ``SoftmaxCELoss`` (:104-127). Each returns one
loss per sample along ``batch_axis`` (the mean over every other axis).
"""
from __future__ import annotations

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if pred.shape != label.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = [i for i in range(loss.dim()) if i != self._batch_axis]
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """(label - pred)² * weight / 2, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``softmax(pred)`` along ``axis``: with
    ``sparse_label`` the label holds class indices (picked from the
    log-probabilities), else a distribution of pred's shape;
    ``from_logits`` takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
