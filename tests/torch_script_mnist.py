#!/usr/bin/env python
"""``examples/gluon_mnist.py`` as a user would write it against the port.

The JAX package's example (a Gluon MLP on MNIST: ``DataLoader`` with two
spawned workers over ``vision.MNIST``, a hybridized ``HybridSequential``,
``Trainer`` with adam, ``metric.Accuracy``), copied line for line. Each line
that differs is marked ``# port:``: the imports, the device
(``mx.tpu()`` becomes ``mx.gpu()``), the argument list and the file the
parameters go to (both parameters of ``main``), and the history ``main``
returns so that a caller can check it; the example's pin of JAX to the CPU
before its imports is gone. Without MNIST's files under
``~/.mxnet/datasets/mnist`` the dataset is the reference's deterministic
synthetic set (8192 training and 1024 validation images).

A helper of the tests and of ``chip_smoke.py``, not a test; it imports only
``mxnet_tpu_torch``. ``transform`` is at module level, so the spawned
workers unpickle it by importing this module.
"""
from __future__ import annotations

import argparse
import time

import mxnet_tpu_torch as mx  # port: was mxnet_tpu
from mxnet_tpu_torch import autograd, gluon, metric, np  # port: was mxnet_tpu
from mxnet_tpu_torch.gluon import nn  # port: was mxnet_tpu
from mxnet_tpu_torch.gluon.data import DataLoader  # port: was mxnet_tpu
from mxnet_tpu_torch.gluon.data.vision import MNIST  # port: was mxnet_tpu


def build_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"),
            nn.Dense(64, activation="relu"),
            nn.Dense(10))
    return net


def transform(sample):
    img, label = sample
    return img.astype("float32") / 255.0, label


def evaluate(net, loader):
    acc = metric.Accuracy()
    for data, label in loader:
        out = net(data.reshape((data.shape[0], -1)))
        acc.update(label, out)
    return acc.get()[1]


def main(argv=None, ctx=None):  # port: argv and ctx are parameters
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--params", default="mnist_mlp.params.npz")  # port
    args = ap.parse_args(argv)  # port: argv

    train_loader = DataLoader(MNIST(train=True).transform(transform),
                              batch_size=args.batch_size, shuffle=True,
                              num_workers=2)
    val_loader = DataLoader(MNIST(train=False).transform(transform),
                            batch_size=args.batch_size)

    net = build_net()
    net.initialize(mx.initializer.Xavier(),
                   ctx=ctx or mx.gpu())  # port: mx.tpu() if mx.num_tpus()
    if not args.no_hybridize:
        net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    history = []  # port: returned to the caller
    for epoch in range(args.epochs):
        tic = time.time()
        train_loss = 0.0
        nbatch = 0
        for data, label in train_loader:
            data = data.reshape((data.shape[0], -1))
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            train_loss += float(loss.mean())
            nbatch += 1
        acc = evaluate(net, val_loader)
        print(f"Epoch {epoch}: loss {train_loss / nbatch:.4f} "
              f"val acc {acc:.4f} ({time.time() - tic:.1f}s)")
        history.append((train_loss / nbatch, acc,
                        time.time() - tic))  # port
    net.save_parameters(args.params)  # port: args.params
    return history  # port


if __name__ == "__main__":
    main()
