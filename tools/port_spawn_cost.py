#!/usr/bin/env python3
"""What starting a spawned ``DataLoader`` worker costs on this machine.

Spawned workers (``gluon.data.DataLoader(num_workers>0)``) start from a
fresh interpreter: ``Process.start()`` launches it, then the worker imports
torch and ``mxnet_tpu_torch`` to unpickle its dataset. This script times
both parts, for 1 and 4 workers, first in a parent that has not touched
CUDA and then in one that holds a CUDA context and ``--gib`` GiB of device
memory (as a training process does):

- ``start``: the host seconds of each ``Process.start()`` call, in the
  parent;
- ``ready``: the seconds from the first ``start()`` until every worker has
  imported torch and ``mxnet_tpu_torch`` and reported back;
- ``import``: each worker's own seconds for those imports.

The workers are started as the DataLoader starts them (spawn context,
``context.spawn_cpu_pinned_env``). The card's name and power limit come
first when a GPU is visible. Run from the repository root::

    python3 tools/port_spawn_cost.py [--gib 8]
"""
import argparse
import os
import subprocess
import sys
import time


def _child(q, t_exec):
    t0 = time.time()
    import torch  # noqa: F401

    import mxnet_tpu_torch  # noqa: F401

    q.put((os.getpid(), time.time() - t0, time.time() - t_exec))


def _measure(n):
    import multiprocessing as mp

    from mxnet_tpu_torch.context import spawn_cpu_pinned_env

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    t_first = time.time()
    procs = [ctx.Process(target=_child, args=(q, t_first), daemon=True)
             for _ in range(n)]
    starts = []
    with spawn_cpu_pinned_env():
        for p in procs:
            t = time.perf_counter()
            p.start()
            starts.append(time.perf_counter() - t)
    reports = [q.get(timeout=600) for _ in procs]
    ready = time.time() - t_first
    for p in procs:
        p.join(timeout=30)
    return starts, ready, [r[1] for r in reports]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=8.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    card = "no GPU"
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; {os.cpu_count()} CPUs",
          flush=True)
    held = None
    for state in ("no CUDA context", "CUDA context"):
        if state == "CUDA context":
            if not torch.cuda.is_available():
                break
            held = torch.empty(int(args.gib * 2**30), dtype=torch.uint8,
                               device="cuda")
            torch.cuda.synchronize()
            state += f" + {args.gib:g} GiB"
        for n in (1, 4):
            starts, ready, imports = _measure(n)
            print(f"{state}, {n} worker(s): start "
                  f"{[round(s, 3) for s in starts]} s, all ready "
                  f"{ready:.3f} s, imports {[round(s, 3) for s in imports]}"
                  f" s", flush=True)
    del held


if __name__ == "__main__":
    main()
