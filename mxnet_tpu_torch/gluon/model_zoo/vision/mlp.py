"""The MNIST MLP, 128-64-10 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mlp.py``)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._utils import build

__all__ = ["MLP", "mlp"]


class MLP(HybridBlock):
    _tensor_body = True

    def __init__(self, hidden=(128, 64), classes=10, activation="relu"):
        super().__init__()
        self.body = nn.HybridSequential()
        for h in hidden:
            self.body.add(nn.Dense(h, activation=activation))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.body(x))


def mlp(**kwargs):
    return build(MLP, **kwargs)
