#!/usr/bin/env python3
"""GPT-2 small's (4, 512) paged prefill in one or more checkouts of the port,
on one GPU, each in a fresh process, in the order given.

For each checkout ROOT, ``mxnet_tpu_torch`` is imported from ROOT and
``GPTModel.forward_prefill_paged`` runs eagerly at (4, 512) (rows of 512,
400, 300 and 200 valid tokens, fp32, random weights from numpy seed 0 by
that checkout's ``chip_smoke.numpy_weights``, 64 pool pages of 128
tokens). Printed per checkout:

- device ms a call: CUDA events around 10 back-to-back calls, median of 5;
- the peak device memory a call takes above what was allocated before it
  (``max_memory_allocated`` after ``reset_peak_memory_stats``);
- the last-token logits' sum, so that two checkouts can be seen to compute
  the same function.

Run from the repository root, e.g. parent, change, change, parent::

    python3 tools/port_prefill_ab.py .proof/parent . . .proof/parent
"""
import os
import statistics
import subprocess
import sys

import numpy as onp


def one(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from chip_smoke import numpy_weights
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    torch.backends.cuda.matmul.allow_tf32 = False
    model = gpt2_small(dropout=0.0)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    model.load_dict(params_from_mxnet_tpu(numpy_weights(shapes, 0), model))
    dev = torch.device("cuda")
    rng = onp.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, 50257, (4, 512)).astype(
        "int32")).to(dev)
    valid = torch.tensor([512, 400, 300, 200], dtype=torch.int32, device=dev)
    kp, vp = model.init_paged_cache(64, 128)
    table = torch.full((4, 9), 64, dtype=torch.int32, device=dev)
    for r in range(4):
        table[r, :4] = torch.arange(r * 8, r * 8 + 4)

    def call():
        return model.forward_prefill_paged(toks, valid, table, kp, vp)[0]

    with torch.inference_mode():
        last = call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        per = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            per.append(start.elapsed_time(end) / 10)
    print(f"[prefill a/b] {root}: forward_prefill_paged (4, 512) "
          f"{statistics.median(per):.3f} ms (CUDA events, median of 5 x 10;"
          f" {', '.join(f'{x:.3f}' for x in per)}); peak above allocated "
          f"{peak / 2**20:.1f} MiB; logits sum {float(last.sum()):.6e}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    roots = sys.argv[1:] or ["."]
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", root]).returncode
        if rc:
            print(f"[prefill a/b] {root}: exit {rc}")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
