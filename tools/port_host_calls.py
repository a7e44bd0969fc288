#!/usr/bin/env python3
"""Python calls of a hybridized Gluon training step on the CPU, in one or
more checkouts of the port, each in a fresh process, in the order given.

For each checkout ROOT, ``mxnet_tpu_torch`` is imported from ROOT. A
2-layer BERT for pretraining (32 units, 2 heads, vocab 100, T = 16, B = 2,
dropout 0, ``initialize(seed=1)``) is hybridized and takes SGD steps
(``autograd.record`` / ``autograd.backward`` / ``trainer.step``): 3 warm
steps, then 10 under ``cProfile``. Printed per checkout: the Python calls a
step, all and primitive. The count is the host's Python work of a step; it
does not depend on the CPU's speed, so two checkouts compare in any order.

Run from the repository root, e.g. parent, then change::

    python3 tools/port_host_calls.py .proof/parent .
"""
import cProfile
import os
import pstats
import subprocess
import sys


def one(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      BERTModel)

    torch.manual_seed(0)
    with mx.cpu():
        model = BERTForPretraining(BERTModel(
            vocab_size=100, max_length=16, dropout=0.0, num_layers=2,
            units=32, hidden_size=64, num_heads=2, device="cpu"),
            vocab_size=100, device="cpu")
        model.initialize(seed=1)
        model.hybridize()
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        tok = torch.randint(0, 100, (2, 16))
        lab = torch.randint(0, 100, (2, 17)).float()
        vl = torch.full((2,), 12.0)

        def step():
            with autograd.record():
                mlm, nsp = model(tok, None, vl)
                loss = loss_fn(mlm, lab[:, :-1]).mean() + \
                    loss_fn(nsp, lab[:, -1]).mean()
            autograd.backward(loss)
            trainer.step(1)

        for _ in range(3):
            step()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            step()
        prof.disable()
    stats = pstats.Stats(prof)
    print(f"[host calls] {root}: hybridized BERT step on the CPU: "
          f"{stats.total_calls / 10:.1f} Python calls a step "
          f"({stats.prim_calls / 10:.1f} primitive)", flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    for root in sys.argv[1:] or ["."]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            print(f"[host calls] {root}: exit {rc}")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
