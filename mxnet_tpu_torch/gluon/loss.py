"""Loss blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base with
``_mean_nonbatch`` and ``_apply_weighting`` (:16-40), ``L2Loss`` (:41),
``L1Loss`` (:52), ``HuberLoss`` (:63), ``SigmoidBinaryCrossEntropyLoss`` /
``SigmoidBCELoss`` (:79-101), ``SoftmaxCrossEntropyLoss`` /
``SoftmaxCELoss`` (:104-127), ``KLDivLoss`` (:130), ``CTCLoss`` (:145),
``HingeLoss`` (:161), ``SquaredHingeLoss`` (:173), ``LogisticLoss``
(:185), ``TripletLoss`` (:202), ``CosineEmbeddingLoss`` (:216),
``PoissonNLLLoss`` (:232) and ``SDMLLoss`` (:262). Most return one loss per
sample along ``batch_axis`` (the mean over every other axis); ``CTCLoss``,
``TripletLoss`` and ``CosineEmbeddingLoss`` one a sample without that
mean, ``PoissonNLLLoss`` the mean over everything, as in the reference.
``weight`` multiplies the loss, ``sample_weight`` (a call argument)
multiplies it per element, broadcast.

A loss follows the dtype of ``pred``, as in the reference: under AMP the
bf16 logits of a tied LM head give a bf16 ``log_softmax``, ``pick`` and
loss, with no upcast (``torch.autocast`` would compute them in fp32).
``max(x, 0)`` is ``torch.maximum``, whose gradient splits a tie in half as
``jnp.maximum``'s does.
"""
from __future__ import annotations

import math

import torch

from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "HuberLoss",
           "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss", "CTCLoss",
           "HingeLoss", "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss", "PoissonNLLLoss", "SDMLLoss"]


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


def _relu(x):
    """``jnp.maximum(x, 0.0)``."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _softplus_form(pred, label):
    """``max(p, 0) - p z + log(1 + exp(-|p|))``: the cross entropy of
    ``sigmoid(p)`` against ``z``, stable for large ``|p|``."""
    return _relu(pred) - pred * label + torch.log1p(torch.exp(-pred.abs()))


class Loss(HybridBlock):
    """Base loss: ``weight``, ``batch_axis`` and the reference's ``prefix``
    and ``params``, which the port's blocks accept and do not use."""

    _tensor_body = True

    def __init__(self, weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = [i for i in range(loss.dim()) if i != self._batch_axis]
        return loss.mean(dim=axes) if axes else loss


class L2Loss(Loss):
    """(label - pred)² * weight / 2, averaged per sample."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred) ** 2
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class L1Loss(Loss):
    """|label - pred|, averaged per sample."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class HuberLoss(Loss):
    """|e| - rho / 2 where |e| > rho, else e² / (2 rho), averaged per
    sample."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss * loss)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of ``sigmoid(pred)`` (or of ``pred`` itself with
    ``from_sigmoid``) against a 0/1 label; ``pos_weight`` weighs the
    positive term (logits only, as in the reference)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            loss = _softplus_form(pred, label)
            if pos_weight is not None:
                loss = loss * ((pos_weight - 1) * label + 1)
        else:
            eps = 1e-12
            loss = -(torch.log(pred + eps) * label +
                     torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``softmax(pred)`` along ``axis``: with
    ``sparse_label`` the label holds class indices (picked from the
    log-probabilities), else a distribution of pred's shape;
    ``from_logits`` takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
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


class KLDivLoss(Loss):
    """label (log(label) - pred): ``pred`` log-probabilities
    (``from_logits``, the default) or logits put through ``log_softmax``
    along ``axis``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        eps = 1e-12
        loss = label * (torch.log(label + eps) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CTCLoss(Loss):
    """CTC loss (the ``ctc_loss`` op, blank the last class) of ``pred``
    logits, ``layout`` ``"NTC"`` or ``"TNC"``, against (N, L) labels
    padded with -1; one loss a sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)     # the op takes (T, N, C)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths,
                          blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class HingeLoss(Loss):
    """max(margin - pred label, 0) for labels of -1 and 1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SquaredHingeLoss(Loss):
    """max(margin - pred label, 0)²."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = _relu(self._margin - pred * label) ** 2
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class LogisticLoss(Loss):
    """The logistic loss of ``pred`` logits; ``label_format`` ``"signed"``
    takes labels of -1 and 1, ``"binary"`` 0 and 1."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _softplus_form(pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class TripletLoss(Loss):
    """max(|pred - positive|² - |pred - negative|² + margin, 0), the squares
    summed over every non-batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = (pred - positive) ** 2 - (pred - negative) ** 2
        axes = list(range(1, pred.dim()))
        loss = _relu(loss.sum(dim=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """1 - cos(input1, input2) for label 1, max(cos - margin, 0)
    otherwise, the cosine along the last axis."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        eps = 1e-12
        sim = (input1 * input2).sum(dim=-1) / (
            torch.linalg.vector_norm(input1, dim=-1) *
            torch.linalg.vector_norm(input2, dim=-1) + eps)
        label = label.reshape(sim.shape)
        loss = torch.where(label == 1, 1.0 - sim, _relu(sim - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, its mean over every element: the
    rate ``exp(pred)`` with ``from_logits``, else ``pred``;
    ``compute_full`` adds Stirling's term where the target exceeds 1."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + epsilon) - target + \
                0.5 * torch.log(2 * (target + epsilon) * math.pi)
            loss = loss + torch.where(target > 1, stirling,
                                      torch.zeros_like(stirling))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: rows ``i`` of ``x1`` and ``x2``
    form the positive pairs, the rest of the batch smoothed negatives; the
    KL divergence between ``softmax(-squared distances)`` and the smoothed
    identity, one value a row."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.smoothing_parameter = smoothing_parameter
        self.kl_loss = KLDivLoss(from_logits=True)

    def forward(self, x1, x2):
        b = x1.shape[0]
        d = ((x1.reshape(b, 1, -1) - x2.reshape(1, b, -1)) ** 2).sum(dim=2)
        eye = torch.eye(b, dtype=torch.float32, device=x1.device)
        labels = eye * (1 - self.smoothing_parameter) + \
            (torch.ones_like(eye) - eye) * self.smoothing_parameter / (b - 1)
        logp = F.log_softmax(-d, axis=1)
        # the KL loss averages over the label axis: times b, its sum
        return self.kl_loss(logp, labels) * b
