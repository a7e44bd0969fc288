#!/usr/bin/env python3
"""How far apart one ResNet-50 v1 training step's gradients lie between
devices and precisions, on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 tools/port_resnet_grads.py

Builds ``chip_smoke.py`` phase 7's ResNet-50 v1 (its seeded weights and its
fp32 batch of 8 at 224 x 224), runs one training-mode forward,
``SoftmaxCrossEntropyLoss`` and backward on the CPU and on the card, in
float32 and float64 (TF32 off; BatchNorm's rsqrt stays fp32 as the
reference's formula has it), and prints, for the 15 parameters whose
card/CPU fp32 gradients differ most over their own largest entry (those
whose gradient is below 1e-4 of the net's largest, rounding noise around a
true zero, left out): that difference, the gradient's largest entry over
the net's, and each run's distance from the CPU's float64 gradient.
"""
import os
import sys
import time

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    if not torch.cuda.is_available():
        print("port_resnet_grads: needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays = cs.resnet_weights(cs.SEED + 7)
    rng = onp.random.default_rng(cs.SEED + 8)
    x8 = rng.standard_normal((cs.RESNET_CHECK_BATCH, *cs.RESNET_IMAGE),
                             dtype="float32")
    y8 = rng.integers(0, cs.RESNET_CLASSES, cs.RESNET_CHECK_BATCH).astype(
        "float32")
    loss_fn = SoftmaxCrossEntropyLoss()
    grads = {}
    for name, ctx, dt in (("cpu32", mx.cpu(), torch.float32),
                          ("gpu32", mx.gpu(), torch.float32),
                          ("gpu64", mx.gpu(), torch.float64),
                          ("cpu64", mx.cpu(), torch.float64)):
        t = time.perf_counter()
        with ctx:
            net = cs._resnet_net(arrays)
            net.cast(dt)
            dev = net.device
            with autograd.record():
                loss = loss_fn(net(torch.from_numpy(x8).to(dev, dt)),
                               torch.from_numpy(y8).to(dev))
            autograd.backward(loss)
            grads[name] = {n: p.grad.detach().double().cpu()
                           for n, p in net.collect_params().items()
                           if p.grad_req != "null"}
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    ref = grads["cpu64"]
    top = max(float(g.abs().max()) for g in ref.values())

    def rel(a, b, m):
        return float((a - b).abs().max()) / m

    rows = []
    for n, g in ref.items():
        m = float(g.abs().max())
        if m <= 1e-4 * top:
            continue
        rows.append((rel(grads["gpu32"][n], grads["cpu32"][n], m), n,
                     m / top, rel(grads["cpu32"][n], g, m),
                     rel(grads["gpu32"][n], g, m),
                     rel(grads["gpu64"][n], g, m)))
    rows.sort(reverse=True)
    print("gpu32-cpu32 | parameter | largest/net's | cpu32-cpu64 | "
          "gpu32-cpu64 | gpu64-cpu64 (each over the gradient's largest)")
    for r in rows[:15]:
        print("%.2e %-34s %.2e %.2e %.2e %.2e" % r)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
