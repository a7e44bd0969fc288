#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's serving path, on one GPU.

Builds GPT-2 small (fp32, random weights from numpy seed 0, as
``chip_smoke.py``) and a ``DecodeEngine`` (8 slots, 1024 positions,
128-token pages), then runs the engine's program families directly on
fixed operands and reports for each:

- wall ms per run (host clock around a synchronised run, median of 10);
- device-busy ms per run (sum of CUDA kernel durations, torch.profiler)
  and the device's idle share (1 - busy / wall);
- kernel launches per run and the kernels that take the most device time.

Families: ``prefill`` at the largest bucket (4 x 512, rows of 512, 400,
300 and 200 valid tokens) and ``decode`` (8 live slots at 300-500 cached
positions). Run from the repository root::

    python3 tools/port_profile.py
"""
import os
import statistics
import sys
import time

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile_family(name, fn, top=12):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / reps
    n_launch = len(kernels) / reps
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    print(f"[{name}] wall {wall:.3f} ms/run (median of 10); device busy "
          f"{busy_us / 1e3:.3f} ms/run; idle share "
          f"{max(0.0, 1 - busy_us / 1e3 / wall):.3f}; "
          f"{n_launch:.0f} kernel launches/run")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for kname, (tot, cnt) in rows:
        print(f"[{name}]   {tot / reps / 1e3:8.4f} ms  x{cnt / reps:5.0f}  "
              f"{kname[:100]}")
    # the host side: operators by their own CPU time (dispatch included)
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_us = sum(e.self_cpu_time_total for e in ops) / reps
    print(f"[{name}] host: {host_us / 1e3:.3f} ms/run of operator self "
          f"time; top operators:")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"[{name}]   {e.self_cpu_time_total / reps / 1e3:8.4f} ms  "
              f"x{e.count / reps:5.0f}  {e.key[:60]}")
    return wall, busy_us / 1e3


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_profile: FAIL: no CUDA device visible")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import numpy_weights

    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, allow_tf32=False")
    model = gpt2_small(dropout=0.0)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    model.load_dict(params_from_mxnet_tpu(numpy_weights(shapes, 0), model))
    eng = DecodeEngine(model, num_slots=8, max_len=1024, max_prompt_len=512,
                       prefill_batch=4, page_tokens=128, prefix_cache=True)
    eng.warmup()
    progs, cache = eng.programs, eng._cache
    dev = torch.device("cuda")
    rng = onp.random.RandomState(1)
    W1 = progs.table_width

    def table(rows, pages_each):
        t = onp.full((rows, W1), progs.kv_pages, "int32")
        for r in range(rows):
            t[r, :pages_each] = onp.arange(r * 8, r * 8 + pages_each)
        return torch.from_numpy(t).to(dev)

    toks = torch.from_numpy(rng.randint(0, 50257, (4, 512)).astype(
        "int32")).to(dev)
    valid = torch.tensor([512, 400, 300, 200], dtype=torch.int32,
                         device=dev)
    ptab = table(4, 4)
    progs.ensure("prefill", batch=4, length=512)
    with torch.inference_mode():
        profile_family("prefill b4 t512", lambda: progs.run(
            ("prefill", 4, 512), [toks, valid, ptab, cache.k, cache.v]))
        dtoks = torch.from_numpy(rng.randint(0, 50257, (8, 1)).astype(
            "int32")).to(dev)
        pos = torch.tensor([300, 330, 360, 390, 420, 450, 480, 500],
                           dtype=torch.int32, device=dev)
        dtab = table(8, 4)
        progs.ensure("decode")
        profile_family("decode s8 k1", lambda: progs.run(
            ("decode", 1), [dtoks, pos, dtab, cache.k, cache.v]))
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
