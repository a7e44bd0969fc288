#!/usr/bin/env python3
"""GPT-2 small's eager training step (``chip_smoke.py`` phase 4's) in one
or more checkouts of the port, on one GPU, each in a fresh process, in the
order given.

For each checkout ROOT, ``mxnet_tpu_torch`` and ``chip_smoke`` are imported
from ROOT and GPT-2 small (12 x 768, vocab 50257, weights from numpy seed 0
by that checkout's ``chip_smoke.train_weights``) takes eager AdamW steps on
tensors at B = 4, T = 1024 (``autograd.record`` / ``autograd.backward`` /
``trainer.step``), dropout 0.1: 2 warm steps, then 20 timed ones in fp32
and 20 under ``amp.autocast("bfloat16")``; in a checkout that has the
NDArray layer (``mxnet_tpu_torch.np``), also 20 fp32 steps through the
NDArray door (the same batches as NDArrays on the card, made before the
loop; ``loss.backward()``), between the two. Printed per checkout and run:
the step's wall ms (host clock around a synchronised step, median of the
20, and their quartiles), and the mean loss of the last step, so that two
checkouts and both doors can be seen to compute the same function.

Run from the repository root, e.g. parent, change, change, parent::

    python3 tools/port_eager_ab.py .proof/parent . . .proof/parent
"""
import contextlib
import os
import statistics
import subprocess
import sys
import time


def one(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from chip_smoke import SEED, TRAIN_SHAPE, cyclic_batches, make_trainer, \
        train_weights
    from mxnet_tpu_torch import amp, autograd, params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    B, T = TRAIN_SHAPE
    dev = torch.device("cuda")
    runs = [("fp32", False), ("fp32", True), ("bf16", False)] if \
        hasattr(mx, "np") else [("fp32", False), ("bf16", False)]
    for prec, door in runs:
        mxrandom.seed(SEED)
        model = gpt2_small(dropout=0.1)
        shapes = {n: tuple(p.shape)
                  for n, p in model.collect_params().items()}
        model.load_dict(params_from_mxnet_tpu(train_weights(shapes, SEED),
                                              model))
        trainer = make_trainer(model)
        loss_fn = SoftmaxCrossEntropyLoss()
        batches = [tuple(torch.from_numpy(a).to(dev) for a in xy)
                   for xy in cyclic_batches(onp.random.RandomState(SEED + 2),
                                            model.vocab_size, B, T, 22)]
        if door:
            batches = [tuple(mx.np.array(t) for t in xy) for xy in batches]
        scope = amp.autocast("bfloat16") if prec == "bf16" else \
            contextlib.nullcontext()
        ms = []
        with scope:
            for x, y in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with autograd.record():
                    loss = loss_fn(model(x), y)
                if door:
                    loss.backward()
                else:
                    autograd.backward(loss)
                trainer.step(B)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        timed = ms[2:]
        q = statistics.quantiles(timed, n=4)
        if door:
            loss = loss._data
        print(f"[eager a/b] {root}: {prec} eager step"
              f"{' (NDArray door)' if door else ''} "
              f"{statistics.median(timed):.3f} ms (median of "
              f"{len(timed)}; quartiles {q[0]:.3f}-{q[2]:.3f}; min "
              f"{min(timed):.3f}); last loss "
              f"{float(loss.detach().float().mean()):.6f}; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        del model, trainer, loss
        torch.cuda.empty_cache()


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    roots = sys.argv[1:] or ["."]
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            print(f"[eager a/b] {root}: exit {rc}")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
