#!/usr/bin/env python3
"""Hybridized Gluon training steps in one or more checkouts of the port, on
one GPU, each checkout in a fresh process, in the order given.

For each checkout ROOT, ``mxnet_tpu_torch`` and ``chip_smoke`` are imported
from ROOT, and these steps (``autograd.record`` / ``autograd.backward`` /
``trainer.step``) are timed:

- ``bert``: ``chip_smoke.py`` phase 9 (iv)'s Gluon loop. BERT-Base for
  pretraining, fp32, dropout 0, T = 128, B = 8, 7/8 of each sequence valid
  (the last 57 tokens), SGD with momentum 0.9, weights from that checkout's
  ``train_weights``. It runs un-hybridized ("eager") and hybridized.
- ``gpt``: the port's ``gpt2_small()`` hybridized, dropout 0.1, phase 4's
  AdamW on phase 4's batches (B = 4, T = 1024, fp32).
- ``script``: phase 11 (iii)'s step, the reference's GPT body
  (``tests/torch_script_gpt.py``) hybridized, on the same weights and
  batches. Only a checkout that has that file runs it.

Each step takes 3 warm calls. Then 20 calls are timed on the host clock,
each followed by a synchronise. Printed per step: the median wall ms and its
quartiles; the host ms until the step returns, before the synchronise (the
host's own work, and any wait on the card inside the step); the device-busy ms of a
step from ``torch.profiler`` over 3 more calls, as ``chip_smoke._profile``
reads it; and the idle share, 1 - busy / wall. The card's name and power
limit come first.

The kernels are built first, in each ROOT; a ROOT whose
``mxnet_tpu_torch/_build`` is a symlink to another's (which holds when their
kernel sources are the same) builds after it and finds them built. Run from
the repository root, e.g. parent, change, change, parent::

    python3 tools/port_gluon_ab.py .proof/parent . . .proof/parent
"""
import os
import statistics
import subprocess
import sys
import time


def _time(step, reps=20):
    import torch

    walls, hosts = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        hosts.append((t1 - t0) * 1e3)
    return walls, hosts


def _report(root, tag, step, profile):
    import torch

    for _ in range(3):
        step()
    walls, hosts = _time(step)
    busy, kernels, _ = profile(step, reps=3)
    wall = statistics.median(walls)
    q = statistics.quantiles(walls, n=4)
    print(f"[gluon a/b] {root}: {tag}: wall {wall:.3f} ms (median of "
          f"{len(walls)}; quartiles {q[0]:.3f}-{q[2]:.3f}), host "
          f"{statistics.median(hosts):.3f} ms, busy {busy:.3f} ms, "
          f"{kernels:.0f} kernels, idle {max(0.0, 1 - busy / wall):.3f}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)


def _bert(root, cs):
    import numpy as onp
    import torch

    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      bert_base)

    rng = onp.random.default_rng(cs.SEED + 16)
    tokens, labels = cs._bert_batch(rng, cs.BERT_CHECK_BATCH)
    tok = torch.from_numpy(tokens).cuda()
    lab = torch.from_numpy(labels).cuda()
    vl = torch.full((cs.BERT_CHECK_BATCH,), float(cs.BERT_VALID),
                    device="cuda")
    vl[-1] = 57.0
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    arrays = None
    for hybrid in (False, True):
        model = BERTForPretraining(bert_base(max_length=cs.BERT_T,
                                             dropout=0.0), vocab_size=30522)
        if arrays is None:
            shapes = {n: tuple(p.shape)
                      for n, p in model.collect_params().items()}
            arrays = cs.train_weights(shapes, cs.SEED + 14)
        model.load_dict(arrays)
        if hybrid:
            model.hybridize()
        trainer = gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})

        def step(model=model, trainer=trainer):
            with autograd.record():
                mlm, nsp = model(tok, None, vl)
                loss = loss_fn(mlm, lab[:, :-1]).mean() + \
                    loss_fn(nsp, lab[:, -1]).mean()
            autograd.backward(loss)
            trainer.step(1)

        _report(root, f"bert {'hybridized' if hybrid else 'eager'}", step,
                cs._profile)
        del model, trainer, step
        torch.cuda.empty_cache()


def _gpt(root, cs):
    import importlib.util

    import numpy as onp
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    B, T = cs.TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    mxrandom.seed(cs.SEED)
    model = gpt2_small(dropout=0.1)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    arrays = cs.train_weights(shapes, cs.SEED)
    batches = [tuple(torch.from_numpy(a).cuda() for a in xy)
               for xy in cs.cyclic_batches(onp.random.RandomState(cs.SEED + 2),
                                           model.vocab_size, B, T, 4)]
    nets = [("gpt", model)]
    path = os.path.join(root, "tests", "torch_script_gpt.py")
    if os.path.exists(path):
        spec = importlib.util.spec_from_file_location("torch_script_gpt",
                                                      path)
        sg = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sg)
        nets.append(("script", sg.ScriptGPT(dropout=0.1)))
    for tag, net in nets:
        if tag == "script":      # reference-style: NDArrays, loss.backward()
            net.load_dict(arrays, ctx=mx.gpu())
            data = [tuple(mx.np.array(t, ctx=mx.gpu()) for t in xy)
                    for xy in batches]
        else:
            net.load_dict(params_from_mxnet_tpu(arrays, net))
            data = batches
        net.hybridize()
        trainer = cs.make_trainer(net)
        it = iter(range(10 ** 6))

        def step(net=net, trainer=trainer, data=data, tag=tag):
            x, y = data[next(it) % len(data)]
            if tag == "script":
                cs._script_step(net, trainer, loss_fn, x, y)
                return
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(B)

        _report(root, f"{tag} hybridized", step, cs._profile)
        del trainer, step
        torch.cuda.empty_cache()


def one(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    _bert(root, cs)
    _gpt(root, cs)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    roots = sys.argv[1:] or ["."]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from mxnet_tpu_torch.ops import _build; _build.build()")
    # a checkout whose _build is a symlink builds after the one it points to
    for root in sorted(set(roots), key=lambda r: os.path.islink(
            os.path.join(r, "mxnet_tpu_torch", "_build"))):
        rc = subprocess.run([sys.executable, "-c", build,
                             os.path.abspath(root)]).returncode
        if rc:
            print(f"[gluon a/b] build in {root}: exit {rc}")
            return rc
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            print(f"[gluon a/b] {root}: exit {rc}")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
