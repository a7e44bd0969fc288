"""``examples/stn_mnist.py`` as a user would write it against the port.

The JAX package's example, copied line for line; the lines that differ
are marked ``# port:`` (the imports), and the example's pin of JAX to the
CPU before its imports is gone. It runs on the current context: ``with
mx.cpu():`` for the host, ``with mx.gpu():`` for the card. A helper of the
tests and of ``chip_smoke.py``, not a test; it imports only
``mxnet_tpu_torch``.

Spatial Transformer Network on MNIST (reference: example/... STN usage
of SpatialTransformer, src/operator/spatial_transformer.cc).

A localization head predicts an affine transform; `npx.spatial_transformer`
warps the input before a small classifier. On randomly translated digits
the STN learns to re-center them — train accuracy beats the same
classifier without the STN.

Run:  python tests/torch_script_stn.py  # port: was examples/stn_mnist.py
"""
import os
import sys

import numpy as onp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxnet_tpu_torch as mx  # noqa: E402  # port: was mxnet_tpu
from mxnet_tpu_torch import autograd, gluon, npx  # noqa: E402  # port
from mxnet_tpu_torch.gluon import nn  # noqa: E402  # port: was mxnet_tpu


class STNClassifier(gluon.HybridBlock):
    def __init__(self, use_stn=True, size=24):
        super().__init__()
        self._use_stn = use_stn
        self._size = size
        if use_stn:
            # predict a DAMPED delta from the identity transform: the
            # classic STN stabilization (large early warps destroy the
            # training signal)
            self.loc = nn.HybridSequential()
            self.loc.add(nn.Dense(32, activation="relu",
                                  in_units=size * size),
                         nn.Dense(6, in_units=32,
                                  weight_initializer="zeros",
                                  bias_initializer="zeros"))
        self.cls = nn.HybridSequential()
        self.cls.add(nn.Dense(64, activation="relu", in_units=12 * 12),
                     nn.Dense(10, in_units=64))

    def forward(self, x):  # x: (B, 1, S, S)
        ident = mx.np.array([1, 0, 0, 0, 1, 0], dtype="float32")
        if self._use_stn:
            delta = self.loc(x.reshape(x.shape[0], -1))
            theta = ident.reshape(1, 6) + 0.3 * delta
        else:
            # fixed identity warp: whole image downsampled to 12x12 — the
            # honest no-localization baseline through the same sampler
            theta = mx.np.broadcast_to(ident.reshape(1, 6),
                                       (x.shape[0], 6))
        x = npx.spatial_transformer(x, theta, target_shape=(12, 12))
        return self.cls(x.reshape(x.shape[0], -1))


def make_translated_digits(n, size=24, seed=0):
    """Synthetic 'digits': 10 distinct 8x8 glyph patterns pasted at random
    offsets in a size×size canvas (keeps the example network-free)."""
    rng = onp.random.RandomState(seed)
    glyphs = rng.uniform(0.5, 1.0, (10, 8, 8)).astype("float32")
    glyphs *= rng.uniform(0, 1, (10, 8, 8)) > 0.4
    xs = onp.zeros((n, 1, size, size), "float32")
    ys = rng.randint(0, 10, n)
    for i, y in enumerate(ys):
        ox, oy = rng.randint(0, size - 8, 2)
        xs[i, 0, oy:oy + 8, ox:ox + 8] = glyphs[y]
    return xs, ys.astype("float32")


def train(use_stn, xs, ys, epochs=40):
    net = STNClassifier(use_stn)
    net.initialize()
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    n, bs = len(ys), 64
    for _ in range(epochs):
        for i in range(0, n, bs):
            xb = mx.np.array(xs[i:i + bs])
            yb = mx.np.array(ys[i:i + bs])
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(xb.shape[0])
    pred = net(mx.np.array(xs)).asnumpy().argmax(-1)
    return float((pred == ys).mean())


def main():
    xs, ys = make_translated_digits(512)
    acc_stn = train(True, xs, ys)
    acc_crop = train(False, xs, ys)
    print(f"with STN:    train acc {acc_stn:.3f}")
    print(f"fixed warp:  train acc {acc_crop:.3f}")
    return acc_stn, acc_crop


if __name__ == "__main__":
    a, b = main()
    assert a > 0.9 and a > b + 0.05, (a, b)
