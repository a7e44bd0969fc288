#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main paths, on one GPU.

Builds GPT-2 small (fp32, random weights from numpy seed 0, as
``chip_smoke.py``) and reports, per program family:

- wall ms per run (host clock around a synchronised run, median of 10);
- device-busy ms per run (sum of CUDA kernel durations, torch.profiler)
  and the device's idle share (1 - busy / wall);
- kernel launches per run and the kernels that take the most device time;
- the host operators that take the most CPU time.

Families:

- ``serve`` (the default): a ``DecodeEngine`` (8 slots, 1024 positions,
  128-token pages) runs its program families directly on fixed operands:
  ``prefill`` at the largest bucket (4 x 512, rows of 512, 400, 300 and 200
  valid tokens) and ``decode`` (8 live slots at 300-500 cached positions);
- ``train``: one training step as ``chip_smoke.py``'s train phase runs it
  (B = 4, T = 1024, dropout 0.1, AdamW with its schedule through
  ``gluon.Trainer`` on the cyclic task), split into its forward, backward
  and optimizer parts with a synchronisation after each, so each part's
  kernels fall inside its own host interval; the whole step is reported
  too, and the run's peak device memory;
- ``train_compiled``: the same training step through
  ``trainer.compile_step`` (one CUDA graph replay a step, after a warm step
  and the capture): wall ms a step (synchronised), device-busy ms, idle
  share and kernel launches per replay, the top kernels, and the run's
  peak device memory;
- ``train_amp`` and ``train_amp_compiled``: the two training steps above
  under ``amp.autocast("bfloat16")`` (the reference's cast at the op: bf16
  GEMMs, bf16 flash kernels, the (B, T, 50257) logits and their loss in
  bf16, LayerNorm on the fp32 residual stream).

Every training family also sums the device time of a step by kind of
kernel (GEMMs, the port's flash kernels, LayerNorm, dtype casts and
copies, softmax and loss, the optimizer's elementwise work, other), so
that a step's time can be split without reading kernel names.

Run from the repository root::

    python3 tools/port_profile.py \
        [serve|train|train_compiled|train_amp|train_amp_compiled|all]
"""
import os
import statistics
import sys
import time

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# kinds of kernels by name (lower case), first match wins; cuBLAS names
# its Hopper GEMMs nvjet_*
_KINDS = (("flash attention (port)", ("flash_fwd_kernel", "flash_bwd")),
          ("layer norm (port)", ("layer_norm_kernel",)),
          ("GEMM", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_",
                    "sm80_")),
          ("softmax and loss", ("softmax", "nll", "cross_entropy",
                                "gather", "scatter")),
          ("casts and copies", ("copy", "convert")),
          ("reductions", ("reduce",)))


def _by_kind(name, by_name, reps):
    """Print the device ms a run of each kind of kernel in ``by_name``
    ({kernel name: (total us, launches)} over ``reps`` runs), with the
    three kernels of each kind that take the most."""
    kinds = {}
    for kname, (tot, cnt) in by_name.items():
        low = kname.lower()
        kind = next((k for k, keys in _KINDS
                     if any(w in low for w in keys)), "other elementwise")
        t, c, top = kinds.get(kind, (0.0, 0, []))
        kinds[kind] = (t + tot, c + cnt, top + [(tot, kname)])
    total = sum(t for t, _, _ in kinds.values()) or 1.0
    for kind, (tot, cnt, top) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][0]):
        print(f"[{name}] by kind: {kind:24s} {tot / reps / 1e3:8.3f} ms "
              f"({100 * tot / total:5.1f} %), x{cnt / reps:5.0f}")
        for t, kname in sorted(top, reverse=True)[:3]:
            print(f"[{name}]     {t / reps / 1e3:8.4f} ms  {kname[:90]}")


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
    _by_kind(name, by_name, reps)
    # the host side: operators by their own CPU time (dispatch included)
    _host_ops(name, prof, reps, top)
    return wall, busy_us / 1e3


def _host_ops(name, prof, reps, top):
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_us = sum(e.self_cpu_time_total for e in ops) / reps
    print(f"[{name}] host: {host_us / 1e3:.3f} ms/run of operator self "
          f"time; top operators:")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"[{name}]   {e.self_cpu_time_total / reps / 1e3:8.4f} ms  "
              f"x{e.count / reps:5.0f}  {e.key[:60]}")


def profile_train(top=12, amp=False):
    """One training step of GPT-2 small, split into forward, backward and
    optimizer; under ``amp.autocast("bfloat16")`` with ``amp``."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import SEED, TRAIN_SHAPE, cyclic_batches, make_trainer, \
        train_weights
    from mxnet_tpu_torch import amp as mxamp
    from mxnet_tpu_torch import autograd, params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    B, T = TRAIN_SHAPE
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model = gpt2_small(dropout=0.1)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    model.load_dict(params_from_mxnet_tpu(train_weights(shapes, SEED),
                                          model))
    trainer = make_trainer(model)
    loss_fn = SoftmaxCrossEntropyLoss()
    batches = cyclic_batches(onp.random.RandomState(SEED + 2),
                             model.vocab_size, B, T, 20)
    phases = ("forward", "backward", "optimizer")

    def step(walls=None):
        x, y = (torch.from_numpy(a).cuda() for a in next(batches))
        marks = [time.perf_counter()]
        with record_function("forward"):
            scope = mxamp.autocast("bfloat16") if amp else \
                contextlib.nullcontext()
            with scope, autograd.record():
                loss = loss_fn(model(x), y)
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        with record_function("backward"):
            autograd.backward(loss)
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        with record_function("optimizer"):
            trainer.step(B)
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if walls is not None:
            for i, ph in enumerate(phases):
                walls[ph].append((marks[i + 1] - marks[i]) * 1e3)

    for _ in range(2):
        step()
    walls = {ph: [] for ph in phases}
    for _ in range(10):
        step(walls)
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
    events = prof.events()
    ranges = {ph: [(e.time_range.start, e.time_range.end) for e in events
                   if e.name == ph and e.device_type ==
                   torch.autograd.DeviceType.CPU] for ph in phases}
    # the profiler mirrors each record_function range on the device as a
    # user annotation; only kernels count as device work
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in phases]
    name = f"train{'_amp' if amp else ''} b{B} t{T}"
    total_wall = total_busy = 0.0
    for ph in phases:
        mine = [e for e in kernels if any(a <= e.time_range.start < b
                                          for a, b in ranges[ph])]
        busy = sum(e.time_range.elapsed_us() for e in mine) / reps / 1e3
        wall = statistics.median(walls[ph])
        total_wall += wall
        total_busy += busy
        print(f"[{name}] {ph}: wall {wall:.3f} ms (median of 10); device "
              f"busy {busy:.3f} ms; idle share "
              f"{max(0.0, 1 - busy / wall):.3f}; "
              f"{len(mine) / reps:.0f} kernel launches")
    print(f"[{name}] step: wall {total_wall:.3f} ms; device busy "
          f"{total_busy:.3f} ms; idle share "
          f"{max(0.0, 1 - total_busy / total_wall):.3f}; "
          f"{len(kernels) / reps:.0f} kernel launches; "
          f"{B * T / total_wall * 1e3:.0f} training tokens/s")
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    for kname, (tot, cnt) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        print(f"[{name}]   {tot / reps / 1e3:8.4f} ms  x{cnt / reps:5.0f}  "
              f"{kname[:100]}")
    _by_kind(name, by_name, reps)
    _host_ops(name, prof, reps, top)
    print(f"[{name}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")


def profile_train_compiled(top=12, amp=False):
    """A training step of GPT-2 small through ``trainer.compile_step``,
    captured under ``amp.autocast("bfloat16")`` with ``amp``."""
    import contextlib
    import itertools

    import torch

    from chip_smoke import SEED, TRAIN_SHAPE, cyclic_batches, make_trainer, \
        train_weights
    from mxnet_tpu_torch import amp as mxamp
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    B, T = TRAIN_SHAPE
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model = gpt2_small(dropout=0.1)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    model.load_dict(params_from_mxnet_tpu(train_weights(shapes, SEED),
                                          model))
    trainer = make_trainer(model)
    step = trainer.compile_step(model, SoftmaxCrossEntropyLoss())
    batches = itertools.cycle([
        (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
        for x, y in cyclic_batches(onp.random.RandomState(SEED + 2),
                                   model.vocab_size, B, T, 8)])
    name = f"train{'_amp' if amp else ''}_compiled b{B} t{T}"
    # the program keeps the AMP state of its first call (the warm step and
    # the capture inside profile_family's first call)
    with mxamp.autocast("bfloat16") if amp else contextlib.nullcontext():
        wall, busy = profile_family(name, lambda: step(*next(batches)), top)
    print(f"[{name}] {B * T / wall * 1e3:.0f} training "
          f"tokens/s; captures {step._traces}; captured launches "
          f"{step.captured_launches}, by dtype {step.captured_dtypes}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB")


def profile_serve():
    import torch

    from chip_smoke import numpy_weights
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.serve.decode import DecodeEngine

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


def main():
    import torch

    family = sys.argv[1] if len(sys.argv) > 1 else "serve"
    families = ("serve", "train", "train_compiled", "train_amp",
                "train_amp_compiled", "all")
    if family not in families:
        print(f"port_profile: unknown family {family!r} {families}")
        return 2
    if not torch.cuda.is_available():
        print("port_profile: FAIL: no CUDA device visible")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, allow_tf32=False, "
          f"allow_bf16_reduced_precision_reduction=False (as chip_smoke.py);"
          f" nvidia-smi: {smi}")
    if family in ("serve", "all"):
        profile_serve()
    if family in ("train", "all"):
        profile_train()
    if family in ("train_compiled", "all"):
        profile_train_compiled()
    if family in ("train_amp", "all"):
        profile_train(amp=True)
    if family in ("train_amp_compiled", "all"):
        profile_train_compiled(amp=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
