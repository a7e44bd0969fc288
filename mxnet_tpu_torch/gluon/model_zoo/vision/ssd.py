"""SSD, the single-shot detector (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/ssd.py``): a base network, a pyramid of
feature blocks, and at each level a class head and a box head (3 x 3
convolutions) and its anchors from ``multibox_prior``.

The outputs, as the reference's:

- ``cls_preds`` (B, num_anchors, num_classes + 1), raw logits, the
  background class first (``ssd_detect`` applies the softmax);
- ``box_preds`` (B, num_anchors * 4), centre-form offsets;
- ``anchors`` (1, num_anchors, 4), corner form in [0, 1], made on the
  device from ``arange`` (so a hybridized SSD makes them in its program).

``ssd_target`` (``multibox_target``, hard negative mining at ratio 3 by
default) and ``ssd_detect`` (softmax, ``multibox_detection``: decoding and
per-class NMS) take those outputs.
"""
from __future__ import annotations

import torch

from .... import numpy as np
from .... import numpy_extension as npx
from ....ops.nn import _Door
from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["SSD", "ssd_300_mobilenet", "ssd_256_lite", "ssd_target",
           "ssd_detect"]

_PRIOR = _Door("multibox_prior")


def _feature_block(channels, stride):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, 1, activation="relu"))
    blk.add(nn.Conv2D(channels, 3, strides=stride, padding=1,
                      activation="relu"))
    return blk


class SSD(HybridBlock):
    """A multi-scale single-shot detector: ``sizes`` and ``ratios`` a
    pyramid level each; ``base`` a feature extractor of the caller's (a zoo
    trunk), else two 3 x 3 convolutions and a 2 x 2 max pool a width of
    ``base_channels``."""

    _tensor_body = True

    def __init__(self, num_classes=20, base_channels=(32, 64, 128),
                 pyramid_channels=(128, 128, 128),
                 sizes=((0.1, 0.15), (0.25, 0.35), (0.5, 0.7)),
                 ratios=((1.0, 2.0, 0.5),) * 3, base=None):
        super().__init__()
        assert len(pyramid_channels) == len(sizes) == len(ratios)
        self.num_classes = num_classes
        self._sizes = tuple(tuple(s) for s in sizes)
        self._ratios = tuple(tuple(r) for r in ratios)
        if base is not None:
            self.base = base
        else:
            self.base = nn.HybridSequential()
            for c in base_channels:
                self.base.add(nn.Conv2D(c, 3, padding=1, activation="relu"))
                self.base.add(nn.Conv2D(c, 3, padding=1, activation="relu"))
                self.base.add(nn.MaxPool2D(2))
        self.stages = nn.HybridSequential()
        self.cls_heads = nn.HybridSequential()
        self.box_heads = nn.HybridSequential()
        for i, c in enumerate(pyramid_channels):
            self.stages.add(_feature_block(c, 1 if i == 0 else 2))
            na = len(self._sizes[i]) + len(self._ratios[i]) - 1
            self.cls_heads.add(nn.Conv2D(na * (num_classes + 1), 3,
                                         padding=1))
            self.box_heads.add(nn.Conv2D(na * 4, 3, padding=1))

    def forward(self, x):
        f = self.base(x)
        cls_list, box_list, anchor_list = [], [], []
        for stage, ch, bh, sizes, ratios in zip(
                self.stages, self.cls_heads, self.box_heads,
                self._sizes, self._ratios):
            f = stage(f)
            anchor_list.append(_PRIOR.fn(sizes=sizes, ratios=ratios)(f))
            c = ch(f)           # (B, na (C + 1), H, W)
            b = bh(f)           # (B, na 4, H, W)
            n = c.shape[0]
            cls_list.append(c.permute(0, 2, 3, 1).reshape(
                n, -1, self.num_classes + 1))
            box_list.append(b.permute(0, 2, 3, 1).reshape(n, -1))
        return (torch.cat(cls_list, 1), torch.cat(box_list, 1),
                torch.cat(anchor_list, 1))


def ssd_target(anchors, cls_preds, labels, overlap_threshold=0.5,
               negative_mining_ratio=3.0):
    """Training targets from the MultiBox matcher: (loc_target, loc_mask,
    cls_target)."""
    return npx.multibox_target(
        anchors, np.transpose(cls_preds, (0, 2, 1)), labels,
        overlap_threshold=overlap_threshold,
        negative_mining_ratio=negative_mining_ratio)


def ssd_detect(cls_preds, box_preds, anchors, nms_threshold=0.45,
               threshold=0.01, nms_topk=400):
    """Decoding and per-class NMS: (B, N, 6) rows [cls, score, x1, y1, x2,
    y2]."""
    cls_prob = np.transpose(npx.softmax(cls_preds, axis=-1), (0, 2, 1))
    return npx.multibox_detection(
        cls_prob, box_preds, anchors, nms_threshold=nms_threshold,
        threshold=threshold, nms_topk=nms_topk)


def ssd_300_mobilenet(num_classes=20, multiplier=1.0, **kwargs):
    """SSD-300 on a MobileNet trunk: its depthwise-separable features up to
    stride 16, then three pyramid levels with stride-2 feature blocks."""
    from .mobilenet import MobileNet

    def make(**kw):
        trunk = MobileNet(multiplier=multiplier).features[:12]  # stride 16
        return SSD(num_classes=num_classes, base=trunk,
                   pyramid_channels=(256, 256, 128), **kw)

    return build(make, **kwargs)


def ssd_256_lite(num_classes=20, **kwargs):
    """A small SSD for tests and the edge: thin base and pyramid."""
    return build(SSD, num_classes=num_classes, base_channels=(16, 32),
                 pyramid_channels=(64, 64),
                 sizes=((0.15, 0.25), (0.4, 0.6)),
                 ratios=((1.0, 2.0, 0.5),) * 2, **kwargs)
