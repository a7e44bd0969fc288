#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):

1. build   — nvcc builds every kernel of the serving, training and tuning
             paths from ``mxnet_tpu_torch/csrc`` (one process per source,
             in parallel, every legal tile instantiated), printing each
             source's seconds, ptxas's registers and spill bytes of the
             flash_fwd, flash_bwd_dq and flash_bwd_dkv instances at head
             dim 64 and the tensor-core (HMMA) instructions cuobjdump finds
             in each of the three libraries (at least one in each);
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card, inputs from a numpy seed: flash-attention forward at
             GPT-2 prefill and training shapes (causal + segment ids with
             right-padded tails and a fully masked row, T up to 1024;
             Tq != Tk non-causal), fp32 max |diff| <= 1e-4 on out and LSE,
             bf16 at (4*12, 512) within one bf16 step of the largest value;
             its times also from CUDA-graph replays, beside SDPA's, and its
             bound at the tensor cores' 3xTF32 (fp32) or bf16 rate with the
             CUDA-core bound beside it; LayerNorm at (rows, 768), max |diff|
             <= 1e-5; the two flash-attention backward kernels (dK/dV, dQ)
             at GPT-2 training shapes (4*12, 1024, 64) causal, 512 with
             padding ids and a fully masked row, ragged 384 and 1000,
             Tq=384/Tk=1000 non-causal), max |diff| <= 1e-4 on dq, dk, dv,
             and bf16 at (4*12, 1024, 64) causal within one bf16 step of
             each gradient's largest value, with CUDA-graph times beside
             the CUDA-event and profiler ones; keys that no query sees get
             exact zeros, and dK/dV in fp32 is also held against a float64
             answer beside the plain version; the bf16 instances of the
             three flash kernels at the AMP training shape (4*12, 1024, 64)
             causal get rows of their own (``name:bf16``) beside SDPA's bf16
             times (``is_causal``), and LayerNorm with bf16 x and fp32
             gamma/beta at (4096, 768) one beside ``F.layer_norm``'s, held
             with the plain version to a float64 answer;
             softmax at (4096, 768), (64, 50257), (1, 50257), ragged row
             counts and both sides of the wide path's threshold (d = 4095,
             4096, 4097, 8191: one warp a row below 4096, one cluster of
             eight blocks a row from it), fp32 max |diff| <= 1e-6, bf16
             |diff| <= 8e-3 |ref| + 1e-7 (one ulp of the value; absolute
             1e-2 would pass zeros at vocabulary width), with
             ``torch.softmax``'s device time beside the kernel's at
             (4096, 768) and (64, 50257) fp32 and bf16; then every kernel once at
             each tile of its legal set (flash (block_q, block_k) in
             {16, 32, 64}^2 at (4*12, 512, 64) causal + ids; LayerNorm and
             softmax block_rows in {1, 2, 4, 8, 16, 32} at (2000, 768)) at
             the same tolerances; kernel, plain and library (SDPA with a
             boolean mask, its autograd backward, F.layer_norm,
             torch.softmax) times, medians of CUDA-event timings;
3. serve   — GPT-2 small (12 x 768, 12 heads, vocab 50257, max_length
             1024, fp32, weights from a numpy seed loaded through
             ``params_from_mxnet_tpu``) served by ``DecodeEngine`` (8 slots,
             128-token pages, prefix cache), tuning off, its program table
             captured as CUDA graphs by ``warmup()`` (43: the tick and 7
             lengths x 3 batches of each prefill family; captures, warmup
             seconds, the graph pool's bytes and peak memory printed): 8
             ragged prompts of 16-500 tokens, 32 new tokens each, two
             sharing a 300-token prefix so the prefix-join program runs.
             Checks: each program's captured launches (12 flash forward in a
             prefill, 25 LayerNorm in every program), the replays while
             serving times those launches against 12 x plain prefills and
             25 x program runs, no capture and no counter move while
             serving, every launch at the default tile, each request's
             last-token prefill logits against the same weights on the CPU
             (relative max |diff| <= 1e-3), and the engine's greedy tokens
             against ``generate(use_cache=False)`` on the card up to the
             first near tie (top-2 logit margin < 1e-3). Then the tick and
             the (4, 512) prefill alone: run wall against device busy and
             the idle share, replay ms, and a replay's tokens and pools
             bit-equal to the eager body's on the same operands; the same 8
             requests through an engine whose programs run their bodies
             eagerly (a private switch), whose tokens must equal the
             captured engine's; and 64 ragged clients on 8 threads (prompts
             of 1-500 tokens, half sharing a 128-token prefix, 1-6 new
             tokens, K = 4, prefix cache) with no capture after warmup and
             stats and counters that add up;
4. train   — GPT-2 small (the same width and depth, GPT-2's N(0, 0.02)
             initialisation from a numpy seed, loaded through
             ``params_from_mxnet_tpu``) trained through
             ``autograd.record`` / ``autograd.backward`` /
             ``gluon.Trainer("adamw").step``, tuning off: one step's
             gradients of every parameter at B=2, T=128 (one row
             right-padded through ``valid_length``, dropout 0) against the
             same weights on the CPU (relative max |diff| <= 1e-3); then 30
             steps at B=4, T=1024 (AdamW with warm-up and a cosine schedule)
             with dropout 0.1 from ``mxnet_tpu_torch.random`` on a
             cyclic-sequence task made from the seed, whose loss must fall
             below half its first value, with 12 launches each of the
             flash forward, dK/dV and dQ kernels and 25 LayerNorm launches
             in every step, all at the default tile; prints step ms,
             training tokens/s and peak device memory;
4b. train (compiled) — the same model through ``trainer.compile_step``
             (one CUDA graph replay a step after a warm step and the
             capture): (i) three compiled and three eager AdamW steps at
             B=4, T=1024, dropout 0, whose losses, weights and Adam states
             agree within rtol 2e-4, atol 1e-6 (the reference's
             cross-program bound); (ii) 30 steps as phase 4's (dropout 0.1)
             whose loss falls below half its first value, one capture, the
             captured body's launches (12 flash forward, 12 dK/dV, 12 dQ,
             25 LayerNorm), no launch outside the warm step and the capture,
             and those kernels found by name in one replay by the profiler;
             (iii) two overflowing ``DynamicLossScaler`` steps (warm and
             replay) leave every weight bitwise and ``num_update`` as they
             were and halve the scale each; (iv) eager and compiled runs in
             the order A B B A, each run's step ms (median of steps 3-30),
             training tokens/s and peak device memory printed beside the
             card's name and power limit;
4c. train (AMP) — the same model and task under
             ``amp.autocast("bfloat16")`` (the reference's cast at the op:
             logits, loss and the flash kernels in bf16, LayerNorm on the
             fp32 residual stream): (i) one eager step at B=2, T=128 (one
             row right-padded, dropout 0): logits and loss bf16, gradients
             fp32 within 3e-2 of each gradient's largest entry of the same
             step on the CPU, 12 bf16 launches of each flash kernel and 25
             fp32 LayerNorm launches; (ii) three compiled and three eager
             AMP steps at B=4, T=1024, dropout 0, within phase 4b (i)'s
             bound, bit-equality printed; (iii) 30 compiled AMP steps as
             4b (ii), whose loss falls below half its first value and ends
             within 1.25x phase 4b (ii)'s last loss, one capture, captured
             launches 12 / 12 / 12 bf16 and 25 fp32 LayerNorm, the bf16
             flash instances found by name in one replay by the profiler;
             (iv) a fresh model through ``amp.convert_hybrid_block`` with
             multi-precision AdamW, 10 eager AMP steps: non-norm weights
             bf16 with fp32 masters, the loss falls, 25 LayerNorm launches
             a step with bf16 x and fp32 gamma/beta; (v) fp32 compiled (A)
             and AMP compiled (B) runs in the order A B B A, step ms,
             training tokens/s and peak memory beside the card's name and
             power limit. bf16 GEMMs sum in fp32
             (``allow_bf16_reduced_precision_reduction`` off, as the MXU);
5. tune    — the tuning workflow at GPT-2 small's width with
             ``MXTPU_TUNE=1`` and a temporary cache file: warm phase 3's
             engine (same weights and arguments) with an empty cache, read
             ``tune.missed()`` (flash_fwd and layer_norm keys), tune exactly
             those plus the flash_bwd and softmax specs of
             ``ladder_specs((1, 4, 8), (128, 512, 1024), 12, 64, 768)``
             (3 trials, 2 tiles an axis, device time from CUDA-graph
             replays), ``save()``; then ``tune.reset()``, a fresh engine,
             ``warmup()`` (which preloads) and phase 3's 8 requests. Checks:
             no cache miss after the preload, ``tune.measurements`` flat
             while serving, the tokens equal to phase 3's up to each
             request's first near tie; prints each spec's winner with its
             default, best and library (``"xla"``) µs, their geometric mean
             default/best, and the library calls. Then the same requests
             through fresh engines untuned (A), tuned (B) and tuned with
             every LayerNorm on its kernel at the default tile (C), in the
             order A B C C B A, each run's tick and prefill medians printed
             and its tokens checked as above;
6. rtc     — the JAX package's rtc test kernel (axpy) as CUDA C through
             ``rtc.CudaModule``, launched at n = 4 and n = 2**24 and held to
             torch's ``2 * x + y`` (relative 1e-6); compile seconds, launch
             ms and the bytes bound.

The lines before the last give the card's name and power limit and a JSON
object of every kernel's numbers with its launches on each path (serve,
train, train_compiled and train_amp (serve: the warm call and the capture
of each program; the compiled steps: the warm step and the capture;
replays move no counter), train_amp_converted, tune, rtc; a row counts the
launches of its dtype instance: fp32 x, or bf16 x for a ``:bf16`` row); the
last line is ``{"ok": true, "device": {...}}``.
"""
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as onp

SEED = 0
PEAK_FP32_FLOPS = 67e12    # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM tensor cores, TF32, dense
PEAK_BF16_FLOPS = 989e12   # H100 SXM tensor cores, bf16, dense
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FLASH_TOL = 1e-4
LN_TOL = 1e-5
SOFTMAX_TOL = 1e-6
BF16_RTOL = 8e-3           # one bf16 ulp of the value: a relative limit
BF16_ATOL = 1e-7
RTC_RTOL = 1e-6
LOGIT_RTOL = 1e-3
GRAD_RTOL = 1e-3
NEAR_TIE = 1e-3
TRAIN_STEPS = 30
TRAIN_LR = 3e-4            # AdamW peak, GPT-3's beta2 = 0.95, 5 warm-up
TRAIN_WARMUP = 5           # steps, then a cosine to TRAIN_LR / 10
TRAIN_SHAPE = (4, 1024)    # batch rows x tokens: GPT-2's own context
TRAIN_WANT = {"flash_fwd": 12, "flash_bwd_dkv": 12, "flash_bwd_dq": 12,
              "layer_norm": 25, "softmax": 0}   # launches a training step
COMPILED_RTOL = 2e-4       # compiled vs eager step: the reference's
COMPILED_ATOL = 1e-6       # cross-program bound (tests/test_train_step.py)
DEV = "cuda"


# launches by (kernel, operand dtypes) of each path's run, for the JSON line
PATH_DTYPES = {}


class SmokeError(Exception):
    pass


def read_counts(path):
    """The kernels' launches since the last reset (``launch_counts``); their
    launches by operand dtypes are kept under ``path`` for the JSON line."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    PATH_DTYPES[path] = ck.dtype_counts()
    return ck.launch_counts()


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=50, rounds=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, the median of ``rounds`` such bursts. Where the
    host launches slower than the card runs, this is the launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_ms(fn, kernel_name, reps=20):
    """Device time per call of the CUDA kernel whose name contains
    ``kernel_name``, in any case (launched once a call), from ``torch.profiler``
    (CUPTI); None when the profiler records no device time for it on this
    machine. CUPTI can drop kernel records: the mean is over the records
    kept, and a shortfall is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name.lower() in evt.key.lower():
            us += getattr(evt, "device_time_total",
                          getattr(evt, "cuda_time_total", 0.0))
            n += evt.count
    if n != reps:
        log(f"[profiler] {kernel_name}: {n} kernel records for {reps} calls")
    return us / n / 1e3 if us > 0 else None


def device_total_ms(fn, reps=10):
    """Device time per call of every kernel ``fn`` launches, summed, from
    ``torch.profiler`` (CUPTI); None when the profiler recorded no kernel
    (CUPTI can drop records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def bound_ms(n_bytes, n_flops, peak=PEAK_FP32_FLOPS):
    """Least time on the card: bytes at the memory rate or operations at
    ``peak`` (default the fp32 CUDA-core rate), whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def attention_bound_ms(n_bytes, n_flops, dtype):
    """The least time for attention at its dtype's accuracy: fp32-accurate
    products on the tensor cores take three TF32 products each (3xTF32),
    bf16 one bf16 product. Returns (ms, "bytes" or "operations", the
    CUDA-core bound of the same work at the fp32 rate)."""
    import torch

    if dtype == torch.float32:
        ms, by = bound_ms(n_bytes, 3 * n_flops, PEAK_TF32_FLOPS)
    else:
        ms, by = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
    return ms, by, bound_ms(n_bytes, n_flops)[0]


def graph_ms(fn, reps=20, rounds=5):
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed between CUDA events, the median of ``rounds``
    replays. The host's launch cost is out of it, so a kernel faster than
    the host launches it reads at its own time."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    """Build every kernel; returns what ptxas and cuobjdump report for each
    tensor-core kernel: the registers and spill line of the default
    (32, 32) fp32 instance at D = 64, the most registers and spill bytes of
    any instance, and the HMMA count."""
    from mxnet_tpu_torch.ops import _build

    info = {}
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for name, cmd, secs, report in _build.build_log:
        log(f"[build] {name}: {secs:.2f} s: {' '.join(cmd)}")
        entries = _ptxas_entries(report)
        regs = [r for _, r, _ in entries]
        spills = [f"{e}: {sp}" for e, _, sp in entries
                  if sp and " 0 bytes spill stores" not in sp]
        log(f"[build]   {len(regs)} kernel instances, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{len(spills)} spill")
        for sp in spills:
            log(f"[build]   spills: {sp}")
        if name in TENSOR_CORE_KERNELS:
            info[name] = _tensor_core_build_report(name, entries, libs[name])
    return info


TENSOR_CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _ptxas_entries(report):
    """(entry, registers, spill line) of each kernel in a ptxas -v report:
    "Function properties for <entry>", then its stack and spill line, then
    "Used N registers"."""
    entries, entry, spill = [], None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            entry, spill = line.split("for", 1)[1].strip(), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            entries.append((entry, int(line.split("Used", 1)[1].split()[0]),
                            spill))
    return entries


def _tensor_core_build_report(name, entries, lib):
    """ptxas's registers and spill bytes of the tensor-core kernel
    ``name``'s instances at head dim 64, and the tensor-core (HMMA)
    instructions cuobjdump finds in its library, where the toolkit has
    cuobjdump; fails if it finds none. Returns the numbers for the JSON
    line."""
    from pathlib import Path

    from mxnet_tpu_torch.ops import _build

    pattern = re.compile(
        name + r"_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E")
    info = {"registers_max": max((r for _, r, _ in entries), default=0),
            "spill_bytes_max": max((int(sp.split(",")[1].split()[0])
                                    for _, _, sp in entries
                                    if "spill stores" in sp), default=0)}
    for entry, regs, spill in entries:
        m = pattern.search(entry or "")
        if m and m.group(2) == "64":
            dtype, _, bq, bk = m.groups()
            log(f"[build]   {name} {'fp32' if dtype == 'f' else 'bf16'} "
                f"D=64 block_q={bq} block_k={bk}: {regs} registers; {spill}")
            if (dtype, bq, bk) == ("f", "32", "32"):
                info["registers_fp32_d64_default"] = regs
                info["spill_fp32_d64_default"] = spill
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        log(f"[build]   {name}: no cuobjdump beside nvcc ({tool}): the "
            f"tensor-core instructions are not counted")
        return info
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = re.findall(r"\bHMMA\.\S+", sass)
    log(f"[build]   {name} library: {len(hmma)} tensor-core (HMMA) "
        f"instructions, {sorted(set(hmma))}, in "
        f"{sass.count('Function : ')} kernel instances")
    check(hmma, f"{name}: no tensor-core instruction in the library")
    info["hmma"] = len(hmma)
    return info


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg):
    import torch

    q, k, v = (torch.from_numpy(rng.randn(B, H, T, D).astype("float32"))
               .to(dev) for T in (Tq, Tk, Tk))
    if not seg:
        return q, k, v, None, None
    # right-padded tails of different lengths, as a prefill batch has
    valid = [Tk - (i * Tk) // (2 * B) for i in range(B)]
    ks = onp.zeros((B, Tk), "int32")
    for i, n in enumerate(valid):
        ks[i, :n] = 1
    qs = onp.ones((B, Tq), "int32")
    qs[B - 1, 0] = 7    # a query row whose id no key shares: fully masked
    return (q, k, v, torch.from_numpy(qs).to(dev),
            torch.from_numpy(ks).to(dev))


def _visible_pairs(qs, ks, B, H, Tq, Tk, causal):
    import torch

    dev = qs.device if qs is not None else "cuda"
    mask = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones((Tq, Tk), dtype=torch.bool,
                           device=dev).tril(Tk - Tq)
    if qs is not None:
        mask &= qs[:, :, None] == ks[:, None, :]
    return mask, int(mask.sum()) * H


def _sdpa_mask_args(mask, causal, seg, Tq, Tk):
    """SDPA's mask arguments for the visible pairs ``mask`` (B, Tq, Tk):
    ``is_causal`` where the mask is causal alone, else the boolean mask."""
    if causal and not seg and Tq == Tk:
        return {"is_causal": True}
    return {"attn_mask": mask[:, None]}


def _bf16_row(row, numbers, err):
    """The JSON row of a kernel's bf16 instance at the AMP training shape:
    ``row``'s name with ``:bf16``, its source and what it replaces, and
    ``numbers``."""
    out = {"name": row["name"] + ":bf16", "route": row["route"],
           "source": row["source"], "replaces": row["replaces"],
           "max_abs_err": err, "dtype": "bfloat16"}
    out.update(numbers)
    return out


def dkv_float64(q, k, v, g, qs, ks, scale, causal):
    """dK and dV in float64 on the card from the dense identities, the
    ground truth that the kernel and the plain fp32 version round away
    from; (B, H, Tk, D) each."""
    import torch

    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    mask = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)[0][:, None]
    s = torch.matmul(qd, kd.transpose(-1, -2)) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e300))
    p = torch.softmax(s, dim=-1) * mask
    delta = (gd * torch.matmul(p, vd)).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gd, vd.transpose(-1, -2)) - delta) * scale
    return (torch.matmul(ds.transpose(-1, -2), qd),
            torch.matmul(p.transpose(-1, -2), gd))


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    rng = onp.random.RandomState(SEED)
    results = {}

    results["flash_fwd"], results["flash_fwd:bf16"] = _flash_fwd_rows(rng,
                                                                      dev)

    # -- fused LayerNorm ----------------------------------------------------
    d = 768
    main = None
    ln_err = 0.0
    for rows in (1, 8, 2000, 2048, 4096):
        x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5)
                             .astype("float32")).to(dev)
        g = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
        b = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
        out = ck.layer_norm_cuda(x, g, b, 1e-5)
        ref = ck.layer_norm_plain(x, g, b, 1e-5)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(err <= LN_TOL,
              f"layer_norm rows={rows}: max |diff| {err:.3g} > {LN_TOL}")
        ln_err = max(ln_err, err)
        def kernel():
            ck.layer_norm_cuda(x, g, b, 1e-5)

        ms = time_ms(kernel)
        dev_ms = device_ms(kernel, "layer_norm_kernel")
        plain_ms = time_ms(lambda: ck.layer_norm_plain(x, g, b, 1e-5))
        def library():
            F.layer_norm(x, (d,), g, b, 1e-5)

        lib_ms = time_ms(library)
        lib_dev_ms = device_ms(library, "layer_norm")
        bms, by = bound_ms(4 * (2 * rows * d + 2 * d), 8 * rows * d)
        log(f"[kernels] layer_norm rows={rows} d={d}: max|diff| {err:.3g};"
            f" kernel {ms:.4f} ms (device {dev_ms}), plain {plain_ms:.4f} "
            f"ms, F.layer_norm {lib_ms:.4f} ms (device {lib_dev_ms}), bound "
            f"{bms:.5f} ms ({by})")
        if rows == 2048:
            main = (ms, plain_ms, lib_ms, bms, by, dev_ms, lib_dev_ms)
    results["layer_norm"] = {
        "name": "layer_norm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/layer_norm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:866",
        "max_abs_err": ln_err, "ms": main[0], "plain_ms": main[1],
        "library_ms": main[2], "bound_ms": main[3], "bound_by": main[4],
        "device_ms": main[5], "library_device_ms": main[6],
        "shape": "x (4*512, 768) fp32, gamma/beta (768,) fp32"}
    results["layer_norm:bf16"] = _layer_norm_bf16_row(rng, dev,
                                                      results["layer_norm"])
    results.update(_flash_bwd_rows(rng, dev))
    results["softmax"] = _softmax_row(rng, dev)
    _every_tile(rng, dev)
    return results


def _layer_norm_bf16_row(rng, dev, row):
    """LayerNorm with bf16 x and fp32 gamma/beta, as a block converted by
    ``amp.convert_hybrid_block`` runs it, at the training step's rows
    (4*1024, 768). The kernel normalises in fp32 and rounds once; the plain
    version (the reference's ``_ln_reference``) rounds x - mean and its
    product with 1/sigma to bf16 first. So both are held to a float64
    answer from the same bf16 x: the kernel within one bf16 rounding
    (2^-8 |exact|) plus fp32's error (2^-18 of the scale below), the plain
    version within four bf16 roundings (2^-8 each of the scale
    (|x_hat| + |mean| / sigma) |gamma| + |beta|), and to each other by the
    sum of the two, each with 1e-6 beside it."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    rows, d = 4096, 768
    x = torch.from_numpy((rng.randn(rows, d) * 2 + 0.5).astype("float32")) \
        .to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    b = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    out = ck.layer_norm_cuda(x, g, b, 1e-5)
    ref = ck.layer_norm_plain(x, g, b, 1e-5)
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    sigma = torch.sqrt(xd.var(-1, unbiased=False, keepdim=True) + 1e-5)
    xhat = (xd - mu) / sigma
    exact = xhat * g.double() + b.double()
    # what the plain version's roundings are relative to: x_hat gamma,
    # beta, and the bf16 mean's rounding carried through gamma / sigma
    scale = (xhat.abs() + mu.abs() / sigma) * g.double().abs() + \
        b.double().abs()
    check(out.dtype == ref.dtype == torch.bfloat16,
          f"layer_norm bf16 x: output dtypes {out.dtype}, {ref.dtype}")
    lim_k = 2 ** -8 * exact.abs() + 2 ** -18 * scale + 1e-6
    lim_p = 4 * 2 ** -8 * scale + 1e-6
    over_k = float(((out.double() - exact).abs() - lim_k).max())
    over_p = float(((ref.double() - exact).abs() - lim_p).max())
    over_kp = float(((out.double() - ref.double()).abs()
                     - (lim_k + lim_p)).max())
    err = float((out.float() - ref.float()).abs().max())
    check(max(over_k, over_p, over_kp) <= 0.0,
          f"layer_norm bf16 x, fp32 gamma/beta: beyond the limits by "
          f"kernel {over_k:.3g}, plain {over_p:.3g}, kernel vs plain "
          f"{over_kp:.3g}")

    def kernel():
        ck.layer_norm_cuda(x, g, b, 1e-5)

    g16, b16 = g.to(x.dtype), b.to(x.dtype)

    def library():
        F.layer_norm(x, (d,), g16, b16, 1e-5)

    ms = time_ms(kernel)
    dev_ms = device_ms(kernel, "layer_norm_kernel")
    plain_ms = time_ms(lambda: ck.layer_norm_plain(x, g, b, 1e-5))
    lib_ms = time_ms(library)
    lib_dev_ms = device_total_ms(library)
    bms, by = bound_ms(2 * 2 * rows * d + 4 * 2 * d, 8 * rows * d)
    log(f"[kernels] layer_norm rows={rows} d={d} bf16 x, fp32 gamma/beta: "
        f"max|diff| from plain {err:.3g}; kernel {ms:.4f} ms (device "
        f"{dev_ms}), plain {plain_ms:.4f} ms, F.layer_norm (gamma/beta in "
        f"bf16) {lib_ms:.4f} ms (device {lib_dev_ms}), bound "
        f"{bms:.5f} ms ({by})")
    out_row = _bf16_row(row, {
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
        "bound_ms": bms, "bound_by": by,
        "shape": f"x ({rows}, {d}) bf16, gamma/beta ({d},) fp32"}, err)
    out_row["dtype"] = "bfloat16 x, float32 gamma/beta"
    return out_row


FWD_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S = QK^T and PV, "
              "fp32 as 3xTF32 (hi/lo split, three products), bf16 one "
              "product; a warp per 16 query rows, K/V tiles by cp.async "
              "into a two-stage shared-memory ring, online softmax on the "
              "accumulator fragments (log2 units), P fed from the S "
              "fragments in a permuted key order")


def _flash_fwd_rows(rng, dev):
    """The flash-attention forward against its plain version at GPT-2
    prefill and training shapes, fp32 held to FLASH_TOL, bf16 to one bf16
    step of the largest value (LSE to FLASH_TOL); times by CUDA events
    (back to back and CUDA-graph replays) and the profiler, beside SDPA's.
    (48, 512, 64) fp32 causal + ids gives the JSON row; (48, 1024, 64) fp32
    and (48, 512, 64) bf16 stand in it under "more". The bf16 instance at
    the AMP training shape, (48, 1024, 64) causal, gives a row of its own
    (returned second), beside SDPA's bf16 device time. Where the mask is
    causal alone, SDPA runs with ``is_causal=True`` (its fastest form of
    the same function), else with the boolean mask."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    err = bf16_err = 0.0
    rows = {}
    for Tq, Tk, causal, seg, dtype in [(128, 128, True, True, f32),
                                       (384, 384, True, True, f32),
                                       (512, 512, True, True, f32),
                                       (1000, 1000, True, True, f32),
                                       (1024, 1024, True, True, f32),
                                       (384, 1000, False, False, f32),
                                       (512, 512, True, True, bf16),
                                       (1024, 1024, True, False, bf16)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        scale = 1.0 / D ** 0.5
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        ref, ref_lse = ck.attention_plain(q, k, v, scale, causal, qs, ks)
        torch.cuda.synchronize()
        e_out = float((out.float() - ref.float()).abs().max())
        e_lse = float((lse - ref_lse).abs().max())
        what = f"flash_fwd T=({Tq},{Tk}) causal={causal} {dtype}"
        if dtype == f32:
            check(max(e_out, e_lse) <= FLASH_TOL, f"{what}: max |diff| out "
                  f"{e_out:.3g}, lse {e_lse:.3g} > {FLASH_TOL}")
            err = max(err, e_out, e_lse)
        else:
            # both sides round one fp32 value to 8 bits: one bf16 step
            step = 2 ** -7 * max(float(ref.float().abs().max()), 1.0)
            check(e_out <= step and e_lse <= FLASH_TOL,
                  f"{what}: max |diff| out {e_out:.3g} (limit {step:.3g}), "
                  f"lse {e_lse:.3g} (limit {FLASH_TOL})")
            bf16_err = max(bf16_err, e_out, e_lse)
        if seg:
            check(float(out[B - 1, :, 0].float().abs().max()) == 0.0,
                  f"{what}: the fully masked row is not zero")
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        sdpa_args = _sdpa_mask_args(mask, causal, seg, Tq, Tk)

        def kernel():
            ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, scale=scale, **sdpa_args)

        ms = time_ms(kernel)
        g_ms = graph_ms(kernel)
        dev_ms = device_ms(kernel, "flash_fwd_kernel")
        plain_ms = time_ms(lambda: ck.attention_plain(q, k, v, scale,
                                                      causal, qs, ks))
        lib_ms = time_ms(sdpa)
        lib_g_ms = graph_ms(sdpa)
        n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                      + out.numel()) + 4 * lse.numel() + (
            4 * (qs.numel() + ks.numel()) if seg else 0)
        bms, by, core_ms = attention_bound_ms(n_bytes, 4 * D * pairs, dtype)
        log(f"[kernels] flash_fwd B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
            f"causal={causal} seg={seg} {dtype}: max|diff| out {e_out:.3g}, "
            f"lse {e_lse:.3g}; kernel {ms:.4f} ms (graph {g_ms:.4f}, "
            f"profiler {dev_ms}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
            f"ms (graph {lib_g_ms:.4f}), bound {bms:.4f} ms ({by}; "
            f"{'3xTF32' if dtype == f32 else 'bf16'} tensor cores, "
            f"{100 * bms / g_ms:.1f} % reached; CUDA-core bound "
            f"{core_ms:.4f} ms), {pairs} visible pairs")
        if (seg and Tq == Tk and Tq in (512, 1024)) or (
                dtype == bf16 and Tq == 1024):
            rows[(Tq, dtype)] = {
                "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_graph_ms": lib_g_ms, "bound_ms": bms,
                "bound_by": by, "cuda_core_bound_ms": core_ms,
                "shape": f"q/k/v ({B}*{H}, {Tq}, {D}) "
                         f"{'fp32' if dtype == f32 else 'bf16'}, causal"
                         f"{' + segment ids' if seg else ''}"}
            if not seg:
                lib_dev = device_total_ms(sdpa)
                rows[(Tq, dtype)]["library_device_ms"] = lib_dev
                log(f"[kernels] flash_fwd {dtype} T={Tq} causal: SDPA "
                    f"(is_causal) device {lib_dev} ms")
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "mxnet_tpu/ops/pallas_kernels.py:163",
           "max_abs_err": err, "design": FWD_DESIGN}
    row.update(rows[(512, f32)])
    row["more"] = [rows[(1024, f32)], rows[(512, bf16)]]
    return row, _bf16_row(row, rows[(1024, bf16)], bf16_err)


def _softmax_row(rng, dev):
    """The softmax kernel against its plain version: GPT-2 width and
    vocabulary width, f32 and bf16, ragged row counts, both sides of the
    wide path's threshold (d = 4095 one warp a row, 4096 one cluster a row)
    and odd widths, whose rows start off 16-byte boundaries; times at
    (4096, 768) fp32 give the JSON row, (64, 50257) fp32 and bf16 (the wide
    path) stand in it under "more". Beside each kernel time stands
    ``torch.softmax``'s on the same input, device time against device time
    (profiler and CUDA-graph replays)."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    err = 0.0
    rows_out = {}
    for rows, d in ((4096, 768), (64, 50257), (1, 50257), (1, 768),
                    (1001, 768), (3, 4095), (3, 4096), (5, 4097),
                    (7, 8191)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(rows, d).astype("float32")).to(
                dev, dtype)
            out = ck.softmax_cuda(x)
            ref = ck.softmax_plain(x)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            e = float(diff.max())
            what = f"softmax ({rows}, {d}) {dtype} " \
                   f"{'wide' if d >= 4096 else 'narrow'} path"
            if dtype == torch.float32:
                check(e <= SOFTMAX_TOL, f"{what}: max |diff| {e:.3g} > "
                      f"{SOFTMAX_TOL}")
                err = max(err, e)
            else:
                # relative: at vocabulary width a value is ~2e-5, so an
                # absolute limit would pass a kernel that wrote zeros
                over = float((diff - BF16_RTOL * ref.float().abs()).max())
                check(over <= BF16_ATOL,
                      f"{what}: |diff| exceeds {BF16_RTOL} |ref| + "
                      f"{BF16_ATOL} by {over:.3g}")
            if (rows, d) not in ((4096, 768), (64, 50257)) or (
                    d == 768 and dtype != torch.float32):
                log(f"[kernels] {what}: max|diff| {e:.3g}")
                continue

            def kernel():
                ck.softmax_cuda(x)

            def library():
                torch.softmax(x, dim=-1)

            ms = time_ms(kernel)
            g_ms = graph_ms(kernel)
            dev_ms = device_ms(kernel, "softmax")
            plain_ms = time_ms(lambda: ck.softmax_plain(x))
            lib_ms = time_ms(library)
            lib_g_ms = graph_ms(library)
            lib_dev_ms = device_ms(library, "softmax")
            es = x.element_size()
            bms, by = bound_ms(2 * rows * d * es, 4 * rows * d)
            log(f"[kernels] {what}: max|diff| {e:.3g}; kernel {ms:.4f} ms "
                f"(graph {g_ms:.5f}, profiler {dev_ms}), plain "
                f"{plain_ms:.4f} ms, torch.softmax {lib_ms:.4f} ms (graph "
                f"{lib_g_ms:.5f}, profiler {lib_dev_ms}), bound {bms:.5f} ms "
                f"({by}, {100 * bms / g_ms:.1f} % reached)")
            rows_out[(rows, d, dtype)] = {
                "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_graph_ms": lib_g_ms,
                "library_device_ms": lib_dev_ms, "bound_ms": bms,
                "bound_by": by,
                "shape": f"x ({rows}, {d}) "
                         f"{'fp32' if dtype == torch.float32 else 'bf16'}, "
                         f"{'one cluster of 8 blocks' if d >= 4096 else 'one warp'}"
                         f" a row"}
    row = {"name": "softmax", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/softmax.cu",
           "replaces": "mxnet_tpu/ops/pallas_kernels.py:971",
           "max_abs_err": err}
    row.update(rows_out[(4096, 768, torch.float32)])
    row["more"] = [rows_out[(64, 50257, torch.float32)],
                   rows_out[(64, 50257, torch.bfloat16)]]
    return row


def _every_tile(rng, dev):
    """Every kernel once at each tile of its legal set, at one shape,
    against its plain version: a tile the tuner may pick is held to the
    math before it can win. Flash: q/k/v/g (4*12, 512, 64) fp32 causal with
    padding ids and a fully masked row; row kernels: (2000, 768) fp32."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, T, D = 4, 12, 512, 64
    scale = 1.0 / D ** 0.5
    q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, T, T, D, True)
    g = torch.from_numpy(rng.randn(B, H, T, D).astype("float32")).to(dev)
    ref, ref_lse = ck.attention_plain(q, k, v, scale, True, qs, ks)
    times = {}
    for bq in ck.FLASH_BLOCKS:
        for bk in ck.FLASH_BLOCKS:
            out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, True, bq, bk)
            grads = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                      True, bq, bk)
            want = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                          scale, True)
            torch.cuda.synchronize()
            e_fwd = max(float((out - ref).abs().max()),
                        float((lse - ref_lse).abs().max()))
            e_bwd = max(float((a - b).abs().max())
                        for a, b in zip(grads, want))
            check(max(e_fwd, e_bwd) <= FLASH_TOL,
                  f"flash tile (block_q={bq}, block_k={bk}): max |diff| "
                  f"fwd {e_fwd:.3g}, bwd {e_bwd:.3g} > {FLASH_TOL}")
            delta = (g * out).sum(dim=-1)
            args = (q, k, v, g, lse, delta, qs, ks, scale, True, bq, bk)
            times[(bq, bk)] = [
                graph_ms(lambda: ck.flash_fwd_cuda(q, k, v, qs, ks, scale,
                                                   True, bq, bk), rounds=3),
                graph_ms(lambda: ck.flash_bwd_dkv_cuda(*args), rounds=3),
                graph_ms(lambda: ck.flash_bwd_dq_cuda(*args), rounds=3),
                e_fwd, e_bwd]
    for (bq, bk), (f, dkv, dq, e_fwd, e_bwd) in times.items():
        log(f"[kernels] tile block_q={bq} block_k={bk} at (48, 512, 64) "
            f"causal + ids: max|diff| fwd {e_fwd:.3g}, bwd {e_bwd:.3g}; "
            f"graph ms flash_fwd {f:.4f}, flash_bwd_dkv {dkv:.4f}, "
            f"flash_bwd_dq {dq:.4f}")
    rows, d = 2000, 768
    x = torch.from_numpy(rng.randn(rows, d).astype("float32")).to(dev)
    gam = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    bet = torch.from_numpy(rng.randn(d).astype("float32")).to(dev)
    ln_ref = ck.layer_norm_plain(x, gam, bet, 1e-5)
    sm_ref = ck.softmax_plain(x)
    for br in ck.ROW_BLOCKS:
        e_ln = float((ck.layer_norm_cuda(x, gam, bet, 1e-5, br) - ln_ref)
                     .abs().max())
        e_sm = float((ck.softmax_cuda(x, br) - sm_ref).abs().max())
        check(e_ln <= LN_TOL and e_sm <= SOFTMAX_TOL,
              f"row tile block_rows={br}: max |diff| layer_norm {e_ln:.3g}"
              f" (limit {LN_TOL}), softmax {e_sm:.3g} (limit "
              f"{SOFTMAX_TOL})")
        t_ln = time_ms(lambda: ck.layer_norm_cuda(x, gam, bet, 1e-5, br),
                       reps=20, rounds=3)
        t_sm = time_ms(lambda: ck.softmax_cuda(x, br), reps=20, rounds=3)
        log(f"[kernels] tile block_rows={br} at (2000, 768): max|diff| "
            f"layer_norm {e_ln:.3g}, softmax {e_sm:.3g}; ms layer_norm "
            f"{t_ln:.4f}, softmax {t_sm:.4f}")


DKV_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S^T = KQ^T, "
              "dP^T = VG^T, dV += P^T G and dK += dS^T Q, fp32 as 3xTF32, "
              "bf16 one product for S^T and dP^T and two for dV and dK "
              "(fp32 p and ds split hi/lo against the exact bf16 value); a "
              "warp per 16 keys, K and V split once: K's fragments in "
              "registers (D <= 64), V's in hi/lo planes in shared memory; Q/G "
              "tiles with their lse, Delta and ids by cp.async into a "
              "two-stage ring; P^T and dS^T fed from their accumulator "
              "fragments in the forward's permuted order; fp32 sums each "
              "query tile from zero and adds it to running sums in shared "
              "memory (the accumulator truncates on every mma)")
DQ_DESIGN = ("mma.sync m16n8k8 TF32 tensor cores for S = QK^T, dP = GV^T "
             "and dQ += dS K, fp32 as 3xTF32, bf16 one product for S and dP "
             "and two for dS K (fp32 ds split hi/lo against K's exact "
             "value); a warp per 16 query rows, Q and G split once: Q's "
             "fragments held in registers (D <= 64), G's in hi/lo planes in "
             "shared memory in fragment order; K/V tiles by cp.async into "
             "the forward's two-stage ring, p from "
             "the known LSE in log2 units with a branch-free mask, dS fed "
             "from its accumulator fragments in the forward's permuted key "
             "order")


def _flash_bwd_rows(rng, dev):
    """The two flash-attention backward kernels against the plain backward
    at GPT-2 training shapes, fp32 held to FLASH_TOL, bf16 to one bf16 step
    of each gradient's largest value; times by CUDA events (back to back
    and CUDA-graph replays) and the profiler. The training shape
    (4*12, 1024, 64) fp32 causal gives the JSON rows, (48, 512, 64) fp32
    causal + ids stands in them under "more"; (48, 1024, 64) bf16 causal,
    the AMP training shape, gives rows of their own (``name:bf16``). The
    library time is autograd through SDPA (``is_causal`` where the mask is
    causal alone) less SDPA's forward."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    scale = 1.0 / D ** 0.5
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    err_bf16 = dict(err)
    rows = {}
    for Tq, Tk, causal, seg, dtype in [(1024, 1024, True, False, f32),
                                       (512, 512, True, True, f32),
                                       (384, 384, True, True, f32),
                                       (1000, 1000, True, True, f32),
                                       (384, 1000, False, False, f32),
                                       (1024, 1024, True, False, bf16)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        g = torch.from_numpy(rng.randn(B, H, Tq, D).astype("float32")) \
            .to(dev, dtype)
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        dq, dk, dv = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                       causal)
        rq, rk, rv = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                            scale, causal)
        torch.cuda.synchronize()
        what = f"flash_bwd T=({Tq},{Tk}) causal={causal} seg={seg} {dtype}"
        diffs = {n: float((a.float() - b.float()).abs().max())
                 for n, a, b in (("dq", dq, rq), ("dk", dk, rk),
                                 ("dv", dv, rv))}
        if dtype == f32:
            limits = dict.fromkeys(diffs, FLASH_TOL)
        else:
            # both sides round one fp32 value to 8 bits: one bf16 step of
            # each gradient's largest value
            limits = {n: 2 ** -7 * max(float(b.float().abs().max()), 1.0)
                      for n, b in (("dq", rq), ("dk", rk), ("dv", rv))}
        check(all(diffs[n] <= limits[n] for n in diffs),
              f"{what}: max |diff| {diffs} over the limits {limits}")
        e_dkv, e_dq = max(diffs["dk"], diffs["dv"]), diffs["dq"]
        if seg:
            check(float(dq[B - 1, :, 0].float().abs().max()) == 0.0,
                  f"{what}: the fully masked row has a gradient")
            # keys with a padding id: no query sees them
            unseen = (ks == 0)[:, None, :, None]
            check(float(torch.where(unseen, dk.float().abs() +
                                    dv.float().abs(), 0.0).max()) == 0.0,
                  f"{what}: a key that no query sees has a gradient")
        exact = {}
        if dtype == f32 and Tq == Tk:
            # both sides against a float64 answer: the kernel's own error,
            # apart from the plain version's
            ek, ev = dkv_float64(q, k, v, g, qs, ks, scale, causal)
            exact = {n: float((a.double() - b).abs().max())
                     for n, a, b in (("kernel dk", dk, ek),
                                     ("kernel dv", dv, ev),
                                     ("plain dk", rk, ek),
                                     ("plain dv", rv, ev))}
            log(f"[kernels] {what}: max |diff| against float64 {exact}; "
                f"max |dk| {float(ek.abs().max()):.3g}, max |dv| "
                f"{float(ev.abs().max()):.3g}")
            del ek, ev
        errs = err if dtype == f32 else err_bf16
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e_dkv)
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
        delta = (g.float() * out.float()).sum(dim=-1)
        args = (q, k, v, g, lse, delta, qs, ks, scale, causal)
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        plain_ms = time_ms(lambda: ck.attention_bwd_plain(
            q, k, v, out, lse, g, qs, ks, scale, causal), reps=10)
        # the library's backward: autograd through SDPA with the same
        # boolean mask, less SDPA's forward alone
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_args = _sdpa_mask_args(mask, causal, seg, Tq, Tk)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                               **sdpa_args)
            torch.autograd.grad(o, (qg, kg, vg), g)

        def lib_fwd():
            F.scaled_dot_product_attention(q, k, v, scale=scale, **sdpa_args)

        lib_ms = time_ms(lib_fwd_bwd, reps=20) - time_ms(lib_fwd, reps=20)
        lib_g_ms = graph_ms(lib_fwd_bwd) - graph_ms(lib_fwd)
        dev_both, dev_fwd = device_total_ms(lib_fwd_bwd), \
            device_total_ms(lib_fwd)
        # None where the profiler dropped the records of either run
        lib_dev_ms = dev_both - dev_fwd if dev_both and dev_fwd and \
            dev_both > dev_fwd else None
        es = q.element_size()
        n_in = es * (q.numel() + k.numel() + v.numel() + g.numel()) + 4 * (
            lse.numel() + delta.numel()) + (
            4 * (qs.numel() + ks.numel()) if seg else 0)
        for name, fn, n_out, flops_per_pair in (
                ("flash_bwd_dkv", ck.flash_bwd_dkv_cuda, 2 * k.numel(), 8),
                ("flash_bwd_dq", ck.flash_bwd_dq_cuda, q.numel(), 6)):
            ms = time_ms(lambda: fn(*args))
            g_ms = graph_ms(lambda: fn(*args))
            dev_ms = device_ms(lambda: fn(*args), name + "_kernel")
            bms, by, core_ms = attention_bound_ms(
                n_in + es * n_out, flops_per_pair * D * pairs, dtype)
            log(f"[kernels] {name} B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
                f"causal={causal} seg={seg} {dtype}: max|diff| "
                f"{e_dkv if name.endswith('dkv') else e_dq:.3g}; kernel "
                f"{ms:.4f} ms (graph {g_ms:.4f}, profiler {dev_ms}), bound "
                f"{bms:.4f} ms ({by}, {'3xTF32' if dtype == f32 else 'bf16'}"
                f" tensor cores, {100 * bms / g_ms:.1f} % reached; CUDA-core "
                f"bound {core_ms:.4f} ms), {pairs} visible pairs")
            if (Tq, Tk) == (1024, 1024) or (Tq, seg) == (512, True):
                rows[(name, Tq, dtype)] = {
                    "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_graph_ms": lib_g_ms,
                    "library_device_ms": lib_dev_ms,
                    "bound_ms": bms, "bound_by": by,
                    "cuda_core_bound_ms": core_ms,
                    "shape": f"q/k/v/g ({B}*{H}, {Tq}, {D}) "
                             f"{'fp32' if dtype == f32 else 'bf16'}, causal"
                             f"{' + segment ids' if seg else ''}; plain and "
                             f"library times cover dq, dk and dv together"}
        log(f"[kernels] flash_bwd {dtype} plain (dq, dk, dv together) "
            f"{plain_ms:.4f} ms; SDPA backward (autograd.grad through "
            f"scaled_dot_product_attention with {list(sdpa_args)[0]}, less "
            f"its forward) {lib_ms:.4f} ms (graph {lib_g_ms:.4f}, profiler "
            f"{lib_dev_ms})")
        if exact and ("flash_bwd_dkv", Tq, dtype) in rows:
            rows[("flash_bwd_dkv", Tq, dtype)]["float64_max_abs_err"] = exact
    results = {}
    for name, src, line in (
            ("flash_bwd_dkv", "flash_bwd.cu", 529),
            ("flash_bwd_dq", "flash_bwd_dq.cu", 587)):
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{src}",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            "max_abs_err": err[name]}
        results[name]["design"] = (DQ_DESIGN if name == "flash_bwd_dq"
                                   else DKV_DESIGN)
        results[name].update(rows[(name, 1024, f32)])
        results[name]["more"] = [rows[(name, 512, f32)]]
        results[name + ":bf16"] = _bf16_row(
            results[name], rows[(name, 1024, bf16)], err_bf16[name])
    return results


# ---------------------------------------------------------------------------
# phase 3: GPT-2 small served by the DecodeEngine
# ---------------------------------------------------------------------------
def numpy_weights(shapes, seed):
    """GPT weights from numpy's ``default_rng(seed)``: LayerNorm gains near
    1, small biases and embeddings, O(1)-gain projections."""
    rs = onp.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.standard_normal(shape, dtype="float32")
        elif name.endswith(("beta", "bias")):
            a = 0.02 * rs.standard_normal(shape, dtype="float32")
        elif "embed" in name:
            a = 0.1 * rs.standard_normal(shape, dtype="float32")
        else:
            a = rs.standard_normal(shape, dtype="float32") \
                / onp.float32(onp.sqrt(shape[1]))
        out[name] = a.astype("float32")
    return out


def make_prompts(rng, vocab):
    lengths = [16, 97, 180, 260, 415, 500]
    shared = rng.randint(0, vocab, size=300).tolist()
    prompts = [rng.randint(0, vocab, size=n).tolist() for n in lengths]
    first = shared + rng.randint(0, vocab, size=40).tolist()    # 340
    second = shared + rng.randint(0, vocab, size=25).tolist()   # 325
    return prompts, first, second


SERVE_ARGS = dict(num_slots=8, max_len=1024, max_prompt_len=512,
                  prefill_batch=4, page_tokens=128, prefix_cache=True)
MAX_NEW = 32


def serve_model():
    """GPT-2 small on the card with the serve phase's weights; returns
    (model, the numpy weights)."""
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    model = gpt2_small(dropout=0.0)                # the GPU: no device arg
    check(model.device.type == "cuda", f"model on {model.device}")
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    arrays = numpy_weights(shapes, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    return model, arrays


def drive_engine(eng, model):
    """The serve phase's 8 requests through a warmed engine: 6 ragged
    prompts and two sharing a 300-token prefix, the second submitted once
    the first has its first token. Returns (requests [(prompt, stream)],
    outputs, seconds, per-family program ms)."""
    import torch

    fam_ms = {"prefill": [], "prefill_ext": [], "decode": []}
    run = eng.programs.run

    # per-family device time: the engine syncs right after each run, so a
    # synchronize after the call adds nothing to what it waits for
    def timed_run(key, datas):
        t = time.perf_counter()
        outs = run(key, datas)
        torch.cuda.synchronize()
        fam_ms[key[0]].append((time.perf_counter() - t) * 1e3)
        return outs

    eng.programs.run = timed_run
    rng = onp.random.RandomState(SEED + 1)
    prompts, first, second = make_prompts(rng, model.vocab_size)
    t_serve = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[:3]]
    s_first = eng.submit(first, max_new_tokens=MAX_NEW)
    streams += [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[3:]]
    deadline = time.perf_counter() + 300
    while not s_first.tokens:        # the tree holds a prompt once prefilled
        check(time.perf_counter() < deadline, "first token never arrived")
        check(not s_first.done or s_first.tokens, "shared request failed")
        time.sleep(0.001)
    s_second = eng.submit(second, max_new_tokens=MAX_NEW)
    reqs = list(zip(prompts, streams)) + [(first, s_first),
                                          (second, s_second)]
    outs = [s.result(timeout=600) for _, s in reqs]
    serve_s = time.perf_counter() - t_serve
    eng.programs.run = run
    return reqs, outs, serve_s, fam_ms


def check_default_tiles(phase):
    """Every launch since the last reset used the default tile."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    want = {"flash_fwd": (32, 32), "flash_bwd_dkv": (32, 32),
            "flash_bwd_dq": (32, 32), "layer_norm": (4,), "softmax": (4,)}
    tiles = ck.tile_counts()
    bad = {k: n for k, n in tiles.items() if want[k[0]] != k[1]}
    check(not bad, f"[{phase}] launches with other than the default tiles:"
          f" {bad}")
    log(f"[{phase}] every launch used the default tile: {tiles}")


SERVE_PROGRAMS = 43        # the tick + 2 prefill families x 7 lengths x 3
SERVE_WANT = {"prefill": {"flash_fwd": 12, "layer_norm": 25},
              "prefill_ext": {"flash_fwd": 0, "layer_norm": 25},
              "decode": {"flash_fwd": 0, "layer_norm": 25}}
RAGGED = dict(clients=64, threads=8, shared=128, longest=500, most_new=6)


def _reserved():
    import torch

    return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)


def warm_engine(model, tag, eager=False, **overrides):
    """A ``DecodeEngine`` with ``SERVE_ARGS`` (and ``overrides``), warmed:
    its whole table captured, or with ``eager`` its bodies run eagerly on
    the card through the programs' private switch. Logs the captures, the
    warmup seconds, the graph pool's bytes (its segments in the allocator's
    snapshot) and the reserved device bytes after warmup less before, each
    read after ``empty_cache``; returns (engine, {captures, warmup_s,
    pool_bytes, reserved_bytes})."""
    import torch

    from mxnet_tpu_torch.serve.decode import DecodeEngine

    eng = DecodeEngine(model, **{**SERVE_ARGS, **overrides})
    if eager:
        eng.programs._graphs = False
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = _reserved()
    t = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    info = {"captures": eng.programs._captures, "warmup_s": warm_s,
            "pool_bytes": eng.programs.pool_bytes(),
            "reserved_bytes": _reserved() - r0}
    log(f"[{tag}] warmup: {len(eng.programs.keys())} programs, "
        f"{info['captures']} {'built (eager bodies)' if eager else 'captured'}"
        f" in {warm_s:.2f} s; graph pool {info['pool_bytes'] / 2**20:.1f} "
        f"MiB; reserved bytes after warmup less before "
        f"{info['reserved_bytes'] / 2**20:.1f} MiB")
    return eng, info


def greedy_upto_tie(model, prompt, max_new):
    """``generate(use_cache=False)``'s tokens after ``prompt`` on the card and
    the step of its first near tie (top-2 logit margin < NEAR_TIE), or
    ``max_new`` when there is none."""
    import torch

    want = model.generate(prompt, max_new_tokens=max_new, use_cache=False,
                          window=len(prompt) + max_new)[len(prompt):]
    seq = torch.tensor([prompt + want], dtype=torch.int32,
                       device=model.device)
    with torch.inference_mode():
        logits = model(seq)[0, len(prompt) - 1:len(prompt) + max_new - 1]
    top = torch.topk(logits, 2, dim=-1).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    return want, next((j for j, m in enumerate(margins) if m < NEAR_TIE),
                      max_new)


def _serve_operands(progs, key, rng, vocab):
    """Operands of the profiled runs: prefill at (4, 512) with rows of 512,
    400, 300 and 200 valid tokens; the tick with 8 live slots at 300-500
    cached positions; each row on its own pages."""
    rows = progs.num_slots if key[0] == "decode" else key[1]
    table = onp.full((rows, progs.table_width), progs.kv_pages, "int32")
    for r in range(rows):
        table[r, :4] = onp.arange(r * 8, r * 8 + 4)
    if key[0] == "decode":
        return [rng.randint(0, vocab, (rows, key[1])).astype("int32"),
                onp.array([300, 330, 360, 390, 420, 450, 480, 500][:rows],
                          "int32"), table]
    return [rng.randint(0, vocab, (rows, key[2])).astype("int32"),
            onp.array([512, 400, 300, 200][:rows], "int32"), table]


def profile_program(eng, key, datas, tag):
    """A program's run (operands in, replay, tokens out, synchronised)
    beside its device time: wall ms (host clock, median of 20 runs), device
    busy ms and kernels a run (profiler), the idle share, and the replay
    alone by CUDA events around 50 back-to-back replays."""
    import torch

    progs, cache = eng.programs, eng._cache
    args = datas + [cache.k, cache.v]

    def run():
        progs.run(key, args)

    run()
    walls = []
    for _ in range(20):
        t = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls)
    busy = device_total_ms(run, reps=10)
    kernels = _kernel_names(run)
    prog = progs._programs[key]
    replay = time_ms(prog.replay, reps=50, rounds=3)
    torch.cuda.synchronize()
    idle = None if busy is None else max(0.0, 1 - busy / wall)
    log(f"[serve] {tag} {'|'.join(map(str, key))}: run wall {wall:.3f} ms "
        f"(median of 20), device busy {busy} ms, idle share {idle}, "
        f"{sum(kernels.values())} device operations a run (kernels and "
        f"copies; the host launches one graph and two copies), replay "
        f"{replay:.3f} ms (CUDA events, 50 back to back)")
    return {"wall_ms": wall, "busy_ms": busy, "idle": idle,
            "replay_ms": replay, "ops": sum(kernels.values())}


def replay_bit_equal(eng, key, datas):
    """One replay's tokens and pools against the eager body's on the same
    operands and the same pools; the pools are left as they were."""
    import torch

    progs, cache = eng.programs, eng._cache
    k0, v0 = cache.k.clone(), cache.v.clone()
    toks, _, _ = progs.run(key, datas + [cache.k, cache.v])
    ka, va = cache.k.clone(), cache.v.clone()
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    prog = progs._programs[key]
    with torch.inference_mode():
        prog.load(datas)
        want = prog.body(cache.k, cache.v).cpu()
    torch.cuda.synchronize()
    same = (torch.equal(toks, want), torch.equal(ka, cache.k),
            torch.equal(va, cache.v), not torch.equal(ka, k0))
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    log(f"[serve] {'|'.join(map(str, key))}: replay against the eager body "
        f"on the same operands and pools: tokens equal {same[0]}, k pool "
        f"bit-equal {same[1]}, v pool bit-equal {same[2]} (pages written: "
        f"{same[3]})")
    check(all(same), f"{key}: the replay differs from the eager body: "
          f"{same}")


def phase_serve():
    import torch

    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    max_new = MAX_NEW
    t0 = time.perf_counter()
    model, arrays = serve_model()
    n_params = sum(int(a.size) for a in arrays.values())
    log(f"[serve] gpt2_small: {len(arrays)} tensors, {n_params} parameters "
        f"from numpy default_rng({SEED}) in {time.perf_counter() - t0:.1f} s")

    # the serve path: the table's warm calls and captures (the launch
    # counters move there only), then the requests, each run a replay
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    eng, info = warm_engine(model, "serve")
    progs = eng.programs
    check(info["captures"] == len(progs.keys()) == SERVE_PROGRAMS,
          f"{info['captures']} captures for {len(progs.keys())} programs, "
          f"expected {SERVE_PROGRAMS}")
    warm_counts = ck.launch_counts()
    gs0 = progs.graph_stats()
    for name, g in gs0.items():
        want = SERVE_WANT[name.split("|")[0]]
        got = g["captured_launches"]
        check(all(got[k] == n for k, n in want.items()),
              f"{name}: captured launches {got}, expected {want}")
    log(f"[serve] captured launches a program: {SERVE_WANT} (all "
        f"{len(gs0)} programs); warm calls and captures launched "
        f"{warm_counts}")
    reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
    counts = read_counts("serve")
    st = eng.stats()
    gs1 = progs.graph_stats()
    peak = torch.cuda.max_memory_allocated()

    n_tok = sum(len(o) for o in outs)
    kinds = st["prefills_by_kind"]
    log(f"[serve] {len(reqs)} requests, {n_tok} tokens in {serve_s:.3f} s: "
        f"{n_tok / serve_s:.1f} tokens/s; prefills {kinds}, ticks "
        f"{st['ticks']}, prefix-hit tokens {st['prefix_hit_tokens']}")
    for fam, xs in fam_ms.items():
        if xs:
            log(f"[serve] {fam}: {len(xs)} runs, median "
                f"{statistics.median(xs):.3f} ms, max {max(xs):.3f} ms")
    log(f"[serve] TTFT p50/p99 {st['ttft_ms_p50']:.1f}/"
        f"{st['ttft_ms_p99']:.1f} ms, TPOT p50/p99 {st['tpot_ms_p50']:.2f}/"
        f"{st['tpot_ms_p99']:.2f} ms, peak device memory "
        f"{peak / 2**20:.1f} MiB")

    check(all(len(o) == max_new for o in outs), "a request came up short")
    check(kinds["prefill_ext"] >= 1 and st["prefix_hit_tokens"] > 0,
          f"the prefix-join family did not run: {kinds}, "
          f"{st['prefix_hit_tokens']} hit tokens")
    check(progs._captures == info["captures"],
          f"serving captured {progs._captures - info['captures']} programs")
    check(counts == warm_counts,
          f"a kernel counter moved while serving: {warm_counts} -> {counts}")
    replays = {n: gs1[n]["replays"] - gs0[n]["replays"] for n in gs1}
    ran = {fam: sum(r for n, r in replays.items() if n.split("|")[0] == fam)
           for fam in SERVE_WANT}
    launched = {k: sum(r * gs1[n]["captured_launches"][k]
                       for n, r in replays.items())
                for k in ("flash_fwd", "layer_norm")}
    log(f"[serve] replays while serving by family {ran}; kernels they ran "
        f"(replays x captured launches) {launched}; counters (warm calls "
        f"and captures only) {counts}")
    check(ran == {"prefill": kinds["prefill"],
                  "prefill_ext": kinds["prefill_ext"],
                  "decode": st["ticks"]},
          f"replays {ran} != program runs {kinds}, {st['ticks']} ticks")
    check(launched["flash_fwd"] == 12 * kinds["prefill"],
          f"flash_fwd replayed {launched['flash_fwd']} != 12 x "
          f"{kinds['prefill']} plain prefills")
    n_runs = st["prefills"] + st["ticks"]
    check(launched["layer_norm"] == 25 * n_runs,
          f"layer_norm replayed {launched['layer_norm']} != 25 x {n_runs} "
          f"program runs")
    check_default_tiles("serve")

    # -- last-token prefill logits: the card against the CPU ---------------
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    all_prompts = [p for p, _ in reqs]
    T = max(len(p) for p in all_prompts)
    toks = onp.zeros((len(all_prompts), T), "int32")
    for i, p in enumerate(all_prompts):
        toks[i, :len(p)] = p
    valid = onp.array([len(p) for p in all_prompts], "int32")
    with torch.inference_mode():
        on_card = model.forward_prefill(
            torch.from_numpy(toks).cuda(),
            torch.from_numpy(valid).cuda())[0].cpu()
        on_cpu = cpu.forward_prefill(torch.from_numpy(toks),
                                     torch.from_numpy(valid))[0]
    del cpu
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    log(f"[serve] prefill last-token logits, card vs CPU: relative max "
        f"|diff| {rel:.3g} (limit {LOGIT_RTOL})")
    check(rel <= LOGIT_RTOL, f"card vs CPU logits differ: {rel:.3g}")

    # -- greedy tokens: the engine against naive generation on the card ----
    ties = []
    for i, ((p, _), got) in enumerate(zip(reqs, outs)):
        want, n = greedy_upto_tie(model, p, max_new)
        if n < max_new:
            ties.append((i, n))
        check(got[:n] == want[:n],
              f"request {i}: engine tokens differ from generate before "
              f"the first near tie (step {n}): {got} vs {want}")
    log(f"[serve] engine tokens == generate(use_cache=False) for all "
        f"{len(reqs)} requests (near ties at (request, step): "
        f"{ties or 'none'})")
    # the tune phase holds its tuned engine to these tokens, each up to its
    # first near tie
    agree = [(got, dict(ties).get(i, max_new)) for i, got in enumerate(outs)]

    # -- the captured programs alone, and against their eager bodies -------
    rng = onp.random.RandomState(SEED + 4)
    vocab = model.vocab_size
    for key in (("decode", 1), ("prefill", 4, 512)):
        profile_program(eng, key, _serve_operands(progs, key, rng, vocab),
                        "captured")
        # fresh tokens: the profiled runs left their own k/v in these pages
        replay_bit_equal(eng, key, _serve_operands(progs, key, rng, vocab))
    eng.close()
    del eng, progs
    _release()

    # -- the same requests through the eager bodies on the card ------------
    eng, _ = warm_engine(model, "serve eager", eager=True)
    _, outs_e, serve_e, fam_e = drive_engine(eng, model)
    ste = eng.stats()
    eng.close()
    del eng
    _release()
    log(f"[serve eager] {sum(len(o) for o in outs_e) / serve_e:.1f} tokens/s"
        f"; " + "; ".join(f"{fam} median {statistics.median(xs):.3f} ms, max "
                          f"{max(xs):.3f} ms" for fam, xs in fam_e.items()
                          if xs) +
        f"; TTFT p50/p99 {ste['ttft_ms_p50']:.1f}/{ste['ttft_ms_p99']:.1f} "
        f"ms, TPOT p50/p99 {ste['tpot_ms_p50']:.2f}/{ste['tpot_ms_p99']:.2f}"
        f" ms (run after the captured engine, same process)")
    check(outs_e == outs, "the eager bodies' tokens differ from the "
          "captured engine's")
    log("[serve] captured engine tokens == eager-body engine tokens for all "
        f"{len(outs)} requests")

    phase_ragged_clients(model, tm)
    return counts, agree


def phase_ragged_clients(model, tm):
    """64 ragged clients on 8 threads against a warmed engine with K = 4 and
    the prefix cache (the analog of the reference's
    tests/test_decode.py:358): prompts of 1-500 tokens, half sharing a
    128-token prefix, 1-6 new tokens each. Nothing captures after warmup
    and the stats and counters add up."""
    import threading

    eng, _ = warm_engine(model, "serve ragged", speculate_k=4, max_queue=128)
    n0 = eng.programs._captures
    rng = onp.random.RandomState(SEED + 6)
    vocab = model.vocab_size
    shared = rng.randint(0, vocab, size=RAGGED["shared"]).tolist()
    ps = [rng.randint(0, vocab, size=rng.randint(1, RAGGED["longest"] + 1))
          .tolist() for _ in range(RAGGED["clients"])]
    for i in range(0, RAGGED["clients"], 2):
        ps[i] = shared + ps[i][:RAGGED["longest"] - RAGGED["shared"]]
    budgets = [1 + i % RAGGED["most_new"] for i in range(RAGGED["clients"])]
    c0 = {n: tm.counter(n).value for n in ("serve.tokens_total",
                                           "serve.requests")}
    per = RAGGED["clients"] // RAGGED["threads"]
    results, errors = {}, []
    barrier = threading.Barrier(RAGGED["threads"] + 1)

    def client(cid):
        barrier.wait()
        try:
            for r in range(per):
                i = cid * per + r
                results[i] = eng.submit(
                    ps[i], max_new_tokens=budgets[i]).result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(RAGGED["threads"])]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=120)
    secs = time.perf_counter() - t0
    st = eng.stats()
    captured = eng.programs._captures - n0
    eng.close()
    check(not errors and not any(t.is_alive() for t in threads),
          f"ragged clients failed: {errors[:3]}")
    total = sum(len(results[i]) for i in range(RAGGED["clients"]))
    log(f"[serve ragged] {RAGGED['clients']} clients on {RAGGED['threads']} "
        f"threads, prompts 1-{RAGGED['longest']} tokens (half sharing "
        f"{RAGGED['shared']}), K=4: {total} tokens in {secs:.2f} s, "
        f"{st['ticks']} ticks, {st['prefills']} prefills "
        f"{st['prefills_by_kind']}, prefix-hit tokens "
        f"{st['prefix_hit_tokens']}, mean accepted "
        f"{st['spec_accept_mean']:.2f}"
        f"; captures after warmup {captured}")
    check(captured == 0, f"{captured} captures after warmup")
    check(st["tokens"] == total == sum(budgets),
          f"tokens {st['tokens']} / {total} != {sum(budgets)}")
    check(st["completed"] == RAGGED["clients"] and st["shed"] == 0,
          f"completed {st['completed']}, shed {st['shed']}")
    check(tm.counter("serve.tokens_total").value - c0["serve.tokens_total"]
          == total and tm.counter("serve.requests").value
          - c0["serve.requests"] == RAGGED["clients"],
          "the serve counters do not add up")
    check(st["prefix_hit_tokens"] > 0 and st["page_starved"] == 0,
          f"prefix hits {st['prefix_hit_tokens']}, starved "
          f"{st['page_starved']}")
    for i in (0, 17, 40, 63):
        want, n = greedy_upto_tie(model, ps[i], budgets[i])
        check(results[i][:n] == want[:n],
              f"ragged request {i} differs from generate before step {n}")
    log("[serve ragged] stats and counters add up; requests 0, 17, 40, 63 "
        "== generate(use_cache=False) up to their first near tie")
    del eng
    _release()



# ---------------------------------------------------------------------------
# phase 4: GPT-2 small trained by the eager Trainer
# ---------------------------------------------------------------------------
def train_weights(shapes, seed):
    """GPT-2's initialisation from numpy's ``default_rng(seed)``: N(0, 0.02)
    matrices and embeddings, LayerNorm gains 1, zero biases."""
    rs = onp.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = onp.ones(shape, "float32")
        elif name.endswith(("beta", "bias")):
            a = onp.zeros(shape, "float32")
        else:
            a = 0.02 * rs.standard_normal(shape, dtype="float32")
        out[name] = a
    return out


def cyclic_batches(rng, vocab, B, T, steps, period=97):
    """A learnable task from the seed: each row walks one fixed cycle of
    ``period`` distinct tokens from its own random offset, so every next
    token follows from the current one."""
    cycle = rng.choice(vocab, size=period, replace=False)
    for _ in range(steps):
        off = rng.randint(0, period, size=(B, 1))
        seq = cycle[(off + onp.arange(T + 1)[None]) % period].astype("int32")
        yield seq[:, :-1], seq[:, 1:]


def make_trainer(model, multi_precision=False):
    """AdamW through ``gluon.Trainer``: peak lr TRAIN_LR after TRAIN_WARMUP
    linear warm-up steps, then a cosine down to a tenth of it at the last
    step; beta2 0.95 and weight decay 0.01 (GPT-3's settings);
    ``multi_precision`` keeps fp32 masters of bf16 weights."""
    from mxnet_tpu_torch import lr_scheduler
    from mxnet_tpu_torch.gluon import Trainer

    sched = lr_scheduler.CosineScheduler(
        max_update=TRAIN_STEPS, base_lr=TRAIN_LR, final_lr=TRAIN_LR / 10,
        warmup_steps=TRAIN_WARMUP)
    return Trainer(model.collect_params(), "adamw",
                   {"learning_rate": TRAIN_LR, "beta2": 0.95, "wd": 0.01,
                    "lr_scheduler": sched,
                    "multi_precision": multi_precision})


def phase_train(smi_line):
    import torch

    from mxnet_tpu_torch import autograd, params_from_mxnet_tpu
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    loss_fn = SoftmaxCrossEntropyLoss()
    model = gpt2_small(dropout=0.0)
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    arrays = train_weights(shapes, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))

    # -- (i) one step's gradients: the card against the CPU ----------------
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    rng = onp.random.RandomState(SEED + 2)
    toks = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                            .astype("int32"))
    tgt = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                           .astype("int32"))
    valid = torch.tensor([128, 77], dtype=torch.int32)   # row 1 padded
    for net, dev in ((model, DEV), (cpu, "cpu")):
        with autograd.record():
            loss = loss_fn(net(toks.to(dev), valid.to(dev)), tgt.to(dev))
        autograd.backward(loss)
    worst, worst_name = 0.0, None
    cpu_params = cpu.collect_params()
    for name, p in model.collect_params().items():
        want = cpu_params[name].grad
        rel = float((p.grad.cpu() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train] one step at B=2, T=128 (row 1 right-padded to 77): "
        f"gradients of all {len(cpu_params)} parameters, card vs CPU, "
        f"worst relative max |diff| {worst:.3g} ({worst_name}; limit "
        f"{GRAD_RTOL})")
    check(worst <= GRAD_RTOL, f"card vs CPU gradients differ: {worst:.3g} "
          f"at {worst_name}")
    del model, cpu, cpu_params, net, loss

    # -- (ii) a training run: AdamW through Trainer, dropout 0.1 ------------
    B, T = TRAIN_SHAPE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model = gpt2_small(dropout=0.1)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    trainer = make_trainer(model)
    losses, step_ms, per_step = [], [], []
    ck.reset_launch_counts()
    for x, y in cyclic_batches(rng, model.vocab_size, B, T, TRAIN_STEPS):
        before = ck.launch_counts()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(model(torch.from_numpy(x).to(DEV)),
                           torch.from_numpy(y).to(DEV))
        autograd.backward(loss)
        trainer.step(B)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach().mean()))
        after = ck.launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
    counts = read_counts("train")
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms[2:])
    log(f"[train] gpt2_small B={B} T={T} AdamW (peak lr {TRAIN_LR}, "
        f"{TRAIN_WARMUP} warm-up steps, cosine), dropout 0.1: loss by step "
        f"{[round(v, 3) for v in losses]}")
    log(f"[train] step {med:.2f} ms (median of steps 3-{TRAIN_STEPS}; first "
        f"two {step_ms[0]:.1f}, {step_ms[1]:.1f} ms), {B * T / med * 1e3:.0f} "
        f"training tokens/s, peak device memory {peak / 2**20:.1f} MiB; "
        f"card {smi_line}")
    log(f"[train] kernel launches in {TRAIN_STEPS} steps: {counts}; per "
        f"step {per_step[-1]}")
    check(all(onp.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the loss did not fall below half its first value: {losses[0]:.3f}"
          f" -> {losses[-1]:.3f}")
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != TRAIN_WANT]
    check(not bad, f"launches per step: step {bad[:1]} != {TRAIN_WANT}")
    check_default_tiles("train")
    return counts


# ---------------------------------------------------------------------------
# phase 4b: GPT-2 small trained by the compiled step (one CUDA graph a step)
# ---------------------------------------------------------------------------
def _train_model(arrays, dropout):
    """GPT-2 small on the card holding ``arrays`` (None: draw them with
    ``train_weights``); returns (model, arrays)."""
    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small

    model = gpt2_small(dropout=dropout)
    if arrays is None:
        arrays = train_weights({n: tuple(p.shape) for n, p in
                                model.collect_params().items()}, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    return model, arrays


def _kernel_names(fn):
    """{kernel name: launches} of the CUDA kernels ``fn`` runs, from
    ``torch.profiler`` (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return names


class _OverflowingLoss:
    """Cross entropy times inf: the scaled loss overflows at any scale."""

    def __init__(self):
        from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

        self.ce = SoftmaxCrossEntropyLoss()

    def __call__(self, pred, label):
        return self.ce(pred, label) * float("inf")


def _release():
    """Free what the last run left: a compiled step and its trainer refer
    to each other, so its graph's memory pool goes only with a collection."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _run_training(arrays, batches, compiled, smi_line, tag, amp=False):
    """One training run of GPT-2 small from ``arrays`` over ``batches``
    (dropout 0.1, ``make_trainer``): eager (record / backward /
    ``Trainer.step(B)``) or compiled (``trainer.compile_step``), under
    ``amp.autocast("bfloat16")`` with ``amp``, each step synchronised and
    timed on the host clock. Returns the losses, the step ms and the peak
    device memory."""
    import contextlib

    import torch

    from mxnet_tpu_torch import amp as mxamp
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    _release()
    held = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = trainer.compile_step(model, loss_fn) if compiled else None
    losses, ms = [], []
    scope = mxamp.autocast("bfloat16") if amp else contextlib.nullcontext()
    with scope:
        for x, y in batches:
            t0 = time.perf_counter()
            if compiled:
                loss = step(x, y)
            else:
                with autograd.record():
                    loss = loss_fn(model(x), y)
                autograd.backward(loss)
                trainer.step(x.shape[0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach().float().mean()))
    peak = torch.cuda.max_memory_allocated() / 2**20
    B, T = batches[0][0].shape
    med = statistics.median(ms[2:])
    log(f"[train-{'amp' if amp else 'compiled'}] timing {tag} "
        f"{'AMP bf16 ' if amp else ''}"
        f"{'compiled' if compiled else 'eager'}: step {med:.2f} ms (median "
        f"of steps 3-{len(ms)}; first two {ms[0]:.1f}, {ms[1]:.1f} ms), "
        f"{B * T / med * 1e3:.0f} training tokens/s, peak device memory "
        f"{peak:.1f} MiB ({held:.1f} MiB held before the run); card "
        f"{smi_line}")
    check(all(onp.isfinite(losses)), f"timing run {tag}: a loss is not "
          "finite")
    del step, trainer, model
    _release()
    return losses, med, peak


def phase_train_compiled(smi_line):
    """GPT-2 small through ``trainer.compile_step``: (i) three compiled
    steps against three eager ones, (ii) 30 training steps, (iii) an
    overflow step, (iv) eager against compiled, A B B A. Returns the
    launch counts of (ii), and its batches and losses."""
    import torch

    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(SEED + 3)

    # -- (i) parity: three compiled steps against three eager ones ---------
    _release()
    comp, arrays = _train_model(None, 0.0)
    eager, _ = _train_model(arrays, 0.0)
    vocab = comp.vocab_size

    def device_batches(n):
        return [(torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV))
                for x, y in cyclic_batches(rng, vocab, B, T, n)]

    tr_c, tr_e = make_trainer(comp), make_trainer(eager)
    step = tr_c.compile_step(comp, loss_fn)
    worst = {"loss": 0.0, "weight": 0.0, "state": 0.0}
    where = {}

    def excess(got, want):
        """max of |got - want| / (atol + rtol |want|): <= 1 passes."""
        return float(((got - want).abs() / (COMPILED_ATOL + COMPILED_RTOL
                                             * want.abs())).max())

    for i, (x, y) in enumerate(device_batches(3)):
        lc = step(x, y)
        with autograd.record():
            le = loss_fn(eager(x), y).mean()
        autograd.backward(le)
        tr_e.step(1)
        e = excess(lc, le.detach())
        if e > worst["loss"]:
            worst["loss"], where["loss"] = e, f"step {i + 1}"
    for (n, p), q in zip(comp.collect_params().items(),
                         eager.collect_params().values()):
        e = excess(p.detach(), q.detach())
        if e > worst["weight"]:
            worst["weight"], where["weight"] = e, n
    for i, (sc, se) in enumerate(zip(tr_c._states, tr_e._states)):
        for k in sc:
            e = excess(sc[k], se[k])
            if e > worst["state"]:
                worst["state"], where["state"] = e, f"{k} of {i}"
    log(f"[train-compiled] (i) 3 compiled vs 3 eager AdamW steps at B={B} "
        f"T={T}, dropout 0: worst |diff| / ({COMPILED_ATOL} + "
        f"{COMPILED_RTOL} |eager|): {worst} at {where} (limit 1); "
        f"num_update {tr_c.optimizer.num_update} vs "
        f"{tr_e.optimizer.num_update}; captures {step._traces}")
    check(max(worst.values()) <= 1.0, f"compiled vs eager differ: {worst} "
          f"at {where}")
    check(tr_c.optimizer.num_update == tr_e.optimizer.num_update == 3,
          "num_update after 3 steps")
    check(step._traces == 1, f"{step._traces} captures in (i)")
    del comp, eager, tr_c, tr_e, step, lc, le
    _release()

    # -- (ii) 30 training steps through compile_step, dropout 0.1 -----------
    torch.cuda.reset_peak_memory_stats()
    log(f"[train-compiled] (ii) device memory held before the run: "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    batches = device_batches(TRAIN_STEPS)
    ck.reset_launch_counts()
    step = trainer.compile_step(model, loss_fn)
    losses, ms = [], []
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        if i == len(batches) - 1:
            holder = []
            names = _kernel_names(lambda: holder.append(step(x, y)))
            loss = holder[0]
        else:
            loss = step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = read_counts("train_compiled")
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[train-compiled] (ii) gpt2_small B={B} T={T} AdamW (peak lr "
        f"{TRAIN_LR}, {TRAIN_WARMUP} warm-up steps, cosine), dropout 0.1, "
        f"{TRAIN_STEPS} steps through trainer.compile_step: loss by step "
        f"{[round(v, 3) for v in losses]}")
    log(f"[train-compiled] (ii) step {statistics.median(ms[2:-1]):.2f} ms "
        f"(median of steps 3-{TRAIN_STEPS - 1}, synchronised; first "
        f"{ms[0]:.1f} ms: warm step and capture), peak device memory "
        f"{peak:.1f} MiB; captures {step._traces}; card {smi_line}")
    log(f"[train-compiled] (ii) launch counters: captured body "
        f"{step.captured_launches}, whole run (warm step + capture) "
        f"{counts}; {TRAIN_STEPS - 1} replays ran the captured body")
    found = {k: n for k, n in names.items() if any(
        w + "_kernel" in k.lower() for w in TRAIN_WANT)}
    log(f"[train-compiled] (ii) the profiler's kernels in step "
        f"{TRAIN_STEPS} (one replay): {len(names)} kernel names, "
        f"{sum(names.values())} launches; the port's kernels: {found}")
    check(all(onp.isfinite(losses)), "a compiled training loss is not "
          "finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the compiled run's loss did not fall below half its first "
          f"value: {losses[0]:.3f} -> {losses[-1]:.3f}")
    check(step._traces == 1, f"{step._traces} captures in 30 steps")
    check(step.captured_launches == TRAIN_WANT,
          f"captured launches {step.captured_launches} != {TRAIN_WANT}")
    check(counts == {k: 2 * n for k, n in TRAIN_WANT.items()},
          f"launches outside the warm step and the capture: {counts}")
    for w, n in TRAIN_WANT.items():
        got = sum(c for k, c in names.items() if w + "_kernel" in k.lower())
        check(got == n, f"the profiler found {got} {w} kernels in one "
              f"replay, not {n}")
    check_default_tiles("train-compiled")
    run_ii = (batches, losses)
    del step, model, trainer, batches, loss, holder
    _release()

    # -- (iii) an overflowing step is a bitwise no-op --------------------------
    model, _ = _train_model(arrays, 0.0)
    trainer = make_trainer(model)
    scaler = amp.DynamicLossScaler()
    step = trainer.compile_step(model, _OverflowingLoss(),
                                loss_scaler=scaler)
    (x, y), = device_batches(1)
    snap = [p.detach().clone() for p in model.collect_params().values()]
    scale0 = scaler.loss_scale
    for call in ("warm step", "replay"):
        step(x, y)
        moved = [n for (n, p), s in zip(model.collect_params().items(), snap)
                 if not torch.equal(p.detach(), s)]
        log(f"[train-compiled] (iii) overflowing {call}: scale "
            f"{scaler.loss_scale}, num_update "
            f"{trainer.optimizer.num_update}, weights moved: {moved}")
        check(not moved, f"the overflowing {call} moved {moved}")
        check(trainer.optimizer.num_update == 0,
              f"num_update moved on overflow ({call})")
    check(scaler.loss_scale == scale0 / 4,
          f"the scale went {scale0} -> {scaler.loss_scale}, not halved "
          "twice")
    check(step._traces == 1, "the overflow step captured twice")
    del step, model, trainer, snap
    _release()

    # -- (iv) eager (A) and compiled (B), in the order A B B A ---------------
    batches = device_batches(TRAIN_STEPS)
    runs = {}
    for tag, compiled in (("A1", False), ("B1", True), ("B2", True),
                          ("A2", False)):
        runs[tag] = _run_training(arrays, batches, compiled, smi_line, tag)
    a = [runs["A1"][1], runs["A2"][1]]
    b = [runs["B1"][1], runs["B2"][1]]
    log(f"[train-compiled] (iv) eager {a} ms, compiled {b} ms a step "
        f"(medians, A B B A); peak MiB eager "
        f"{[runs['A1'][2], runs['A2'][2]]}, compiled "
        f"{[runs['B1'][2], runs['B2'][2]]}; card {smi_line}")
    return counts, run_ii


# ---------------------------------------------------------------------------
# phase 4c: GPT-2 small trained under AMP (bf16), compiled and converted
# ---------------------------------------------------------------------------
BF16 = ("bfloat16",)
AMP_WANT = {("flash_fwd", BF16): 12, ("flash_bwd_dkv", BF16): 12,
            ("flash_bwd_dq", BF16): 12,
            ("layer_norm", ("float32", "float32")): 25}
CONVERTED_WANT = {**AMP_WANT, ("layer_norm", ("float32", "float32")): 0,
                  ("layer_norm", ("bfloat16", "float32")): 25}
AMP_GRAD_RTOL = 3e-2       # bf16's roundoff 3.9e-3, GEMM orders, 12 layers
AMP_LOSS_RATIO = 1.25      # last AMP loss against the fp32 run's
CONVERTED_STEPS = 10


def phase_train_amp(smi_line, fp32_run):
    """GPT-2 small under ``amp.autocast("bfloat16")``: (i) one eager step's
    gradients against the CPU's, (ii) three compiled AMP steps against
    three eager ones, (iii) 30 compiled AMP steps on the batches, weights
    and dropout seed of phase 4b (ii)'s fp32 run (``fp32_run``: its
    batches and losses), so that precision is all that differs, (iv) a
    block converted by ``amp.convert_hybrid_block`` with multi-precision
    AdamW, 10 eager steps, (v) fp32 compiled (A) against AMP compiled (B),
    A B B A on one set of batches."""
    import torch

    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, T = TRAIN_SHAPE
    loss_fn = SoftmaxCrossEntropyLoss()
    rng = onp.random.RandomState(SEED + 4)

    # -- (i) one AMP step's gradients: the card against the CPU --------------
    _release()
    model, arrays = _train_model(None, 0.0)
    cpu = gpt2_small(dropout=0.0, device="cpu")
    cpu.load_dict(arrays)
    toks = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                            .astype("int32"))
    tgt = torch.from_numpy(rng.randint(0, model.vocab_size, (2, 128))
                           .astype("int32"))
    valid = torch.tensor([128, 77], dtype=torch.int32)   # row 1 padded
    ck.reset_launch_counts()
    for net, dev in ((model, DEV), (cpu, "cpu")):
        with amp.autocast("bfloat16"):
            with autograd.record():
                logits = net(toks.to(dev), valid.to(dev))
                loss = loss_fn(logits, tgt.to(dev))
            autograd.backward(loss)
        check(logits.dtype == loss.dtype == torch.bfloat16,
              f"[{dev}] AMP logits {logits.dtype}, loss {loss.dtype}: not "
              f"bfloat16")
    dts = ck.dtype_counts()
    worst, worst_name = 0.0, None
    cpu_params = cpu.collect_params()
    for name, p in model.collect_params().items():
        want = cpu_params[name].grad
        check(p.grad.dtype == want.dtype == torch.float32,
              f"{name}: gradient dtype {p.grad.dtype} on the card, "
              f"{want.dtype} on the CPU, not float32")
        rel = float((p.grad.cpu() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train-amp] (i) one AMP (bf16) step at B=2, T=128 (row 1 "
        f"right-padded to 77): logits and loss bfloat16, gradients float32; "
        f"all {len(cpu_params)} gradients card vs CPU, worst relative max "
        f"|diff| {worst:.3g} ({worst_name}; limit {AMP_GRAD_RTOL}); "
        f"launches by dtype {dts}")
    check(worst <= AMP_GRAD_RTOL, f"AMP card vs CPU gradients differ: "
          f"{worst:.3g} at {worst_name}")
    check(dts == AMP_WANT, f"AMP step launches by dtype {dts} != "
          f"{AMP_WANT}")
    del model, cpu, cpu_params, net, loss, logits

    # -- (ii) three compiled AMP steps against three eager ones --------------
    _release()
    comp, _ = _train_model(arrays, 0.0)
    eager, _ = _train_model(arrays, 0.0)
    vocab = comp.vocab_size

    def device_batches(n):
        return [(torch.from_numpy(x).to(DEV), torch.from_numpy(y).to(DEV))
                for x, y in cyclic_batches(rng, vocab, B, T, n)]

    tr_c, tr_e = make_trainer(comp), make_trainer(eager)
    step = tr_c.compile_step(comp, loss_fn)
    worst = {"loss": 0.0, "weight": 0.0, "state": 0.0}
    where, bitwise = {}, True

    def excess(got, want):
        return float(((got.float() - want.float()).abs()
                      / (COMPILED_ATOL + COMPILED_RTOL
                         * want.float().abs())).max())

    with amp.autocast("bfloat16"):
        for i, (x, y) in enumerate(device_batches(3)):
            lc = step(x, y)
            with autograd.record():
                le = loss_fn(eager(x), y).mean()
            autograd.backward(le)
            tr_e.step(1)
            bitwise &= bool(torch.equal(lc, le.detach().float()))
            e = excess(lc, le.detach())
            if e > worst["loss"]:
                worst["loss"], where["loss"] = e, f"step {i + 1}"
    for (n, p), q in zip(comp.collect_params().items(),
                         eager.collect_params().values()):
        bitwise &= bool(torch.equal(p, q))
        e = excess(p.detach(), q.detach())
        if e > worst["weight"]:
            worst["weight"], where["weight"] = e, n
    for i, (sc, se) in enumerate(zip(tr_c._states, tr_e._states)):
        for k in sc:
            bitwise &= bool(torch.equal(sc[k], se[k]))
            e = excess(sc[k], se[k])
            if e > worst["state"]:
                worst["state"], where["state"] = e, f"{k} of {i}"
    log(f"[train-amp] (ii) 3 compiled vs 3 eager AMP AdamW steps at B={B} "
        f"T={T}, dropout 0: worst |diff| / ({COMPILED_ATOL} + "
        f"{COMPILED_RTOL} |eager|): {worst} at {where} (limit 1); "
        f"bit-equal {bitwise}; captures {step._traces}")
    check(max(worst.values()) <= 1.0, f"compiled vs eager AMP steps differ: "
          f"{worst} at {where}")
    check(step._traces == 1, f"{step._traces} captures in (ii)")
    del comp, eager, tr_c, tr_e, step, lc, le
    _release()

    # -- (iii) 30 compiled AMP steps, dropout 0.1, phase 4b (ii)'s run --------
    batches, fp32_losses = fp32_run
    fp32_final_loss = fp32_losses[-1]
    torch.cuda.reset_peak_memory_stats()
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    trainer = make_trainer(model)
    losses, ms = [], []
    ck.reset_launch_counts()
    with amp.autocast("bfloat16"):
        step = trainer.compile_step(model, loss_fn)
        for i, (x, y) in enumerate(batches):
            t0 = time.perf_counter()
            if i == len(batches) - 1:
                holder = []
                names = _kernel_names(lambda: holder.append(step(x, y)))
                loss = holder[0]
            else:
                loss = step(x, y)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    counts = read_counts("train_amp")
    peak = torch.cuda.max_memory_allocated() / 2**20
    found = {k: n for k, n in names.items() if any(
        w + "_kernel" in k.lower() for w in TRAIN_WANT)}
    log(f"[train-amp] (iii) gpt2_small B={B} T={T} AdamW, dropout 0.1, "
        f"{TRAIN_STEPS} compiled AMP (bf16) steps on phase 4b (ii)'s "
        f"batches, weights and dropout seed: loss by step "
        f"{[round(v, 3) for v in losses]}; the fp32 run's "
        f"{[round(v, 3) for v in fp32_losses]}")
    log(f"[train-amp] (iii) step {statistics.median(ms[2:-1]):.2f} ms "
        f"(median of steps 3-{TRAIN_STEPS - 1}, synchronised; first "
        f"{ms[0]:.1f} ms: warm step and capture), peak device memory "
        f"{peak:.1f} MiB; captures {step._traces}; captured launches "
        f"{step.captured_launches}, by dtype {step.captured_dtypes}; card "
        f"{smi_line}")
    log(f"[train-amp] (iii) the profiler's kernels in step {TRAIN_STEPS} "
        f"(one replay): {len(names)} kernel names, {sum(names.values())} "
        f"launches; the port's kernels: {found}")
    check(all(onp.isfinite(losses)), "an AMP training loss is not finite")
    check(losses[-1] < 0.5 * losses[0],
          f"the AMP run's loss did not fall below half its first value: "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    check(losses[-1] <= AMP_LOSS_RATIO * fp32_final_loss,
          f"the AMP run ended at {losses[-1]:.3f}, above {AMP_LOSS_RATIO} x "
          f"the fp32 run's {fp32_final_loss:.3f}")
    check(step._traces == 1, f"{step._traces} captures in 30 AMP steps")
    check(step.captured_launches == TRAIN_WANT,
          f"captured launches {step.captured_launches} != {TRAIN_WANT}")
    check(step.captured_dtypes == AMP_WANT,
          f"captured launches by dtype {step.captured_dtypes} != {AMP_WANT}")
    check(counts == {k: 2 * n for k, n in TRAIN_WANT.items()},
          f"launches outside the warm step and the capture: {counts}")
    for w, n in TRAIN_WANT.items():
        mine = {k: c for k, c in found.items() if w + "_kernel" in k.lower()}
        check(sum(mine.values()) == n, f"the profiler found "
              f"{sum(mine.values())} {w} kernels in one replay, not {n}")
        bf16_names = [k for k in mine if "bfloat16" in k.lower()]
        want_bf16 = w.startswith("flash")
        check(len(bf16_names) == (len(mine) if want_bf16 else 0),
              f"{w}: the replay ran {mine}, not the "
              f"{'bf16' if want_bf16 else 'fp32'} instance")
    check_default_tiles("train-amp")
    del step, model, trainer, batches, loss, holder
    _release()

    # -- (iv) a converted block with multi-precision AdamW -------------------
    mxrandom.seed(SEED)
    model, _ = _train_model(arrays, 0.1)
    amp.convert_hybrid_block(model)
    trainer = make_trainer(model, multi_precision=True)
    bad = [n for n, p in model.collect_params().items() if p.dtype != (
        torch.float32 if n.endswith(("gamma", "beta")) else torch.bfloat16)]
    check(not bad, f"convert_hybrid_block left these in another dtype: {bad}")
    losses, per_step, ms = [], [], []
    ck.reset_launch_counts()
    with amp.autocast("bfloat16"):
        for x, y in device_batches(CONVERTED_STEPS):
            before = ck.dtype_counts()
            t0 = time.perf_counter()
            with autograd.record():
                loss = loss_fn(model(x), y)
            autograd.backward(loss)
            trainer.step(B)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach().float().mean()))
            after = ck.dtype_counts()
            per_step.append({k: after.get(k, 0) - before.get(k, 0)
                             for k in CONVERTED_WANT})
    read_counts("train_amp_converted")
    masters = [st["weight_fp32"] for st in trainer._states
               if st is not None and "weight_fp32" in st]
    n_bf16 = sum(p.dtype == torch.bfloat16 for p in model.parameters())
    log(f"[train-amp] (iv) converted block (non-norm weights bf16), AdamW "
        f"multi_precision, dropout 0.1, {CONVERTED_STEPS} eager steps at "
        f"B={B} T={T}: loss by step {[round(v, 3) for v in losses]}; "
        f"{statistics.median(ms[2:]):.2f} ms a step; {len(masters)} fp32 "
        f"masters for {n_bf16} bf16 weights; launches by dtype a step "
        f"{per_step[-1]}")
    check(all(onp.isfinite(losses)), "a converted-block loss is not finite")
    check(losses[-1] < losses[0], f"the converted block's loss did not "
          f"fall: {losses[0]:.3f} -> {losses[-1]:.3f}")
    check(len(masters) == n_bf16 and all(
        m.dtype == torch.float32 for m in masters),
          f"{len(masters)} masters for {n_bf16} bf16 weights")
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != CONVERTED_WANT]
    check(not bad, f"converted-block launches by dtype: step {bad[:1]} != "
          f"{CONVERTED_WANT}")
    del model, trainer, masters, loss
    _release()

    # -- (v) fp32 compiled (A) and AMP compiled (B), A B B A ------------------
    batches = device_batches(TRAIN_STEPS)
    runs = {}
    for tag, use_amp in (("A1", False), ("B1", True), ("B2", True),
                         ("A2", False)):
        runs[tag] = _run_training(arrays, batches, True, smi_line, tag,
                                  amp=use_amp)
    log(f"[train-amp] (v) compiled fp32 "
        f"{[runs['A1'][1], runs['A2'][1]]} ms, compiled AMP bf16 "
        f"{[runs['B1'][1], runs['B2'][1]]} ms a step (medians of steps "
        f"3-{TRAIN_STEPS}, A B B A); training tokens/s fp32 "
        f"{[round(B * T / runs[t][1] * 1e3) for t in ('A1', 'A2')]}, AMP "
        f"{[round(B * T / runs[t][1] * 1e3) for t in ('B1', 'B2')]}; peak "
        f"MiB fp32 {[runs['A1'][2], runs['A2'][2]]}, AMP "
        f"{[runs['B1'][2], runs['B2'][2]]}; last losses fp32 "
        f"{[round(runs[t][0][-1], 3) for t in ('A1', 'A2')]}, AMP "
        f"{[round(runs[t][0][-1], 3) for t in ('B1', 'B2')]}; card "
        f"{smi_line}")


# ---------------------------------------------------------------------------
# phase 5: the tuning path (discover, tune, save, preload, serve)
# ---------------------------------------------------------------------------
def phase_tune(agree):
    import shutil
    import tempfile

    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch import tune
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mxtpu_tune_smoke_")
    os.environ["MXTPU_TUNE"] = "1"
    os.environ["MXTPU_TUNE_CACHE"] = os.path.join(tmp, "tuning.json")

    def n(name):
        return int(tm.counter(name).value)

    try:
        tune.reset()
        ck.reset_launch_counts()
        model, _ = serve_model()
        # (1) discovery: warm the phase-3 engine with an empty cache
        eng = DecodeEngine(model, **SERVE_ARGS)
        eng.warmup()
        eng.close()
        del eng
        _release()
        worklist = tune.missed()
        fams = sorted({kern for kern, _ in worklist})
        log(f"[tune] discovery warmup: {len(worklist)} missed keys "
            f"({fams}), {n('tune.cache_misses')} misses, library calls "
            f"{ck.library_counts()}")
        check({"flash_fwd", "layer_norm"} <= set(fams),
              f"discovery missed no flash_fwd/layer_norm keys: {fams}")
        # (2) tune exactly those, plus the training-shaped ladder
        specs = [tune.spec_from_key(k) for _, k in worklist]
        specs += tune.ladder_specs((1, 4, 8), (128, 512, 1024), 12, 64, 768,
                                   families=("flash_bwd", "softmax"))
        t0 = time.perf_counter()
        results = tune.autotune(specs, trials=3, max_per_axis=2)
        tune_s = time.perf_counter() - t0
        check(os.path.exists(os.environ["MXTPU_TUNE_CACHE"]),
              "tune.save() wrote no cache file")
        for r in results:
            log(f"[tune] {r['key']}: winner {r['winner']} "
                f"{json.dumps(r['config'])}, default {r['default_us']:.2f} "
                f"us, best {r['best_us']:.2f} us, xla {r['xla_us']:.2f} us")
        gm = statistics.geometric_mean(
            [r["default_us"] / r["best_us"] for r in results])
        wins = {}
        for r in results:
            w = "xla" if r["winner"] == "xla" else (
                "default" if r["winner"] == "default" else "other tile")
            wins[w] = wins.get(w, 0) + 1
        log(f"[tune] {len(results)} specs in {tune_s:.1f} s, "
            f"{n('tune.measurements')} measurements; geometric mean of "
            f"default/best {gm:.4f}; winners {wins}")
        # (3) a fresh process's view: drop the in-process tier, preload
        tune.reset()
        eng = DecodeEngine(model, **SERVE_ARGS)
        m0, h0 = n("tune.cache_misses"), n("tune.cache_hits")
        lib0 = ck.library_counts()
        eng.warmup()
        m1, meas1 = n("tune.cache_misses"), n("tune.measurements")
        log(f"[tune] fresh engine warmup after preload: "
            f"{tune.status()['entries']} entries, {n('tune.cache_hits') - h0}"
            f" hits, {m1 - m0} misses")
        check(m1 == m0, f"{m1 - m0} cache misses after the preload")
        reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        del eng
        _release()
        lib = {f: c - lib0[f] for f, c in ck.library_counts().items()}
        check(n("tune.measurements") == meas1,
              "the serving engine measured candidates online")
        check(n("tune.cache_misses") == m1, "cache misses while serving")
        n_tok = sum(len(o) for o in outs)
        med = {f: statistics.median(x) for f, x in fam_ms.items() if x}
        log(f"[tune] tuned engine: {len(reqs)} requests, {n_tok} tokens in "
            f"{serve_s:.3f} s ({n_tok / serve_s:.1f} tokens/s); median ms "
            f"{ {f: round(v, 3) for f, v in med.items()} }; library-lowering"
            f" calls in the warm calls and captures {lib}")
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"request {i}: tuned tokens differ from the untuned "
                  f"engine's before step {upto}: {got} vs {want}")
        log(f"[tune] tuned engine tokens == untuned engine tokens up to "
            f"each request's first near tie")
        counts = read_counts("tune")
        log(f"[tune] kernel launches on the path: {counts}; library calls "
            f"{ck.library_counts()}; tiles {ck.tile_counts()}")
        check(counts["softmax"] > 0, "the tune path launched no softmax")
        _tick_ab(model, agree)
        secs = time.perf_counter() - t_phase
        log(f"[tune] phase {secs:.1f} s")
        return counts, results
    finally:
        os.environ.pop("MXTPU_TUNE", None)
        os.environ.pop("MXTPU_TUNE_CACHE", None)
        tune.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def _tick_ab(model, agree):
    """What moves the tuned engine's tick. The same 8 requests, each time
    through a fresh warmed engine, in the order A B C C B A within this
    process so that run order cannot stand in for a difference: A untuned;
    B tuned (the saved winners); C tuned, but every LayerNorm key pinned to
    its kernel at the default tile, which leaves the decode tick's one
    tuned choice (the LayerNorm at 8 rows) as untuned. Prints each run's
    decode-tick and prefill medians; checks only the tokens."""
    from mxnet_tpu_torch import tune
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    def serve(variant):
        tune.reset()
        if variant == "A":
            os.environ.pop("MXTPU_TUNE", None)
        else:
            os.environ["MXTPU_TUNE"] = "1"
            if variant == "C":
                tune.preload()
                for key in tune.entries():
                    if key.startswith("layer_norm|"):
                        tune.record("layer_norm", key,
                                    {"block_rows": ck.DEFAULT_BLOCK_ROWS})
        eng = DecodeEngine(model, **SERVE_ARGS)
        lib0 = ck.library_counts()["layer_norm"]
        eng.warmup()
        _, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        del eng
        _release()
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"[tune A/B] {variant}: request {i} differs from the "
                  f"untuned engine before step {upto}")
        tick = statistics.median(fam_ms["decode"])
        pre = statistics.median(fam_ms["prefill"])
        n_tok = sum(len(o) for o in outs)
        log(f"[tune A/B] {variant}: decode tick median {tick:.3f} ms "
            f"({len(fam_ms['decode'])} ticks), prefill median {pre:.3f} ms, "
            f"{n_tok / serve_s:.1f} tokens/s, F.layer_norm calls in the "
            f"warm calls and captures "
            f"{ck.library_counts()['layer_norm'] - lib0}")
        return tick

    ticks = {v: [] for v in "ABC"}
    try:
        for v in "ABCCBA":
            ticks[v].append(serve(v))
    finally:
        os.environ["MXTPU_TUNE"] = "1"
        tune.reset()
    log("[tune A/B] decode tick medians, ms: " + "; ".join(
        f"{v} {ticks[v][0]:.3f} / {ticks[v][1]:.3f}" for v in "ABC"))


# ---------------------------------------------------------------------------
# phase 6: runtime-compiled CUDA (rtc.CudaModule)
# ---------------------------------------------------------------------------
AXPY = r'''
extern "C" __global__ void axpy(const float* x, const float* y, float* out,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.0f * x[i] + y[i];
}
'''


def phase_rtc():
    """The JAX package's rtc test kernel (tests/test_contrib.py:150-159) as
    CUDA C, compiled at run time and launched at n = 4 and n = 2**24 on
    the path; held to torch's 2 * x + y."""
    import torch

    from mxnet_tpu_torch import rtc

    t0 = time.perf_counter()
    mod = rtc.CudaModule(AXPY)
    compile_s = time.perf_counter() - t0
    sig = "const float* x, const float* y, float* out, int n"
    dev = torch.device("cuda")
    rng = onp.random.RandomState(SEED + 3)
    inputs = {}
    for n in (4, 1 << 24):
        inputs[n] = tuple(torch.from_numpy(rng.randn(n).astype("float32"))
                          .to(dev) for _ in range(2))
    kernels = {n: mod.get_kernel("axpy", sig, out_shapes=[(n,)])
               for n in inputs}
    rtc.reset_launch_count()
    outs = {n: kernels[n].launch([x, y, n]) for n, (x, y) in inputs.items()}
    torch.cuda.synchronize()
    launches = rtc.launch_count()
    err = 0.0
    for n, (x, y) in inputs.items():
        want = 2 * x + y
        rel = float(((outs[n] - want).abs()
                     / want.abs().clamp_min(1e-30)).max())
        check(rel <= RTC_RTOL, f"rtc axpy n={n}: relative |diff| {rel:.3g}")
        err = max(err, float((outs[n] - want).abs().max()))
    n = 1 << 24
    x, y = inputs[n]
    ms = time_ms(lambda: kernels[n].launch([x, y, n]))
    dev_ms = device_ms(lambda: kernels[n].launch([x, y, n]), "axpy")
    plain_ms = time_ms(lambda: 2 * x + y)
    lib_ms = time_ms(lambda: torch.add(y, x, alpha=2))
    bms, by = bound_ms(12 * n, 2 * n)
    log(f"[rtc] axpy compiled in {compile_s:.2f} s; launches on the path "
        f"{launches}; n=2^24: max|diff| {err:.3g}; kernel {ms:.4f} ms "
        f"(device {dev_ms}), plain 2 * x + y {plain_ms:.4f} ms, "
        f"torch.add(alpha=2) {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    check(launches == 2, f"rtc launches on the path {launches} != 2")
    return {"name": "rtc_axpy", "route": "cuda",
            "source": "mxnet_tpu_torch/rtc.py",
            "replaces": "mxnet_tpu/rtc.py:35",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "device_ms": dev_ms, "launches": launches,
            "shape": "x, y (2^24,) fp32, axpy compiled by rtc.CudaModule"}


# ---------------------------------------------------------------------------
def main():
    try:
        import torch
    except ImportError:
        log("chip_smoke: FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: FAIL: no CUDA device visible")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        log("chip_smoke: FAIL: run from a checkout (mxnet_tpu_torch/ is "
            "not beside this script)")
        return 1
    sys.path.insert(0, here)
    # fp32 parity phases: full-precision matmuls and convolutions; bf16
    # GEMMs (phase 4c) sum in fp32 throughout, split-K partials included,
    # as the MXU that the reference runs on accumulates in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; "
        f"allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    for var in ("MXTPU_TUNE", "MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K"):
        os.environ.pop(var, None)            # phases 1-4 run untuned
    try:
        t0 = time.perf_counter()
        build_info = phase_build()
        kernels = phase_kernels()
        _, agree = phase_serve()
        phase_train(smi_line)
        _, fp32_run = phase_train_compiled(smi_line)
        phase_train_amp(smi_line, fp32_run)
        phase_tune(agree)
        rtc_row = phase_rtc()
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — every failure ends the run non-zero
        traceback.print_exc()
        log("chip_smoke: FAIL")
        return 1
    log(smi_line)
    for name, row in kernels.items():
        # a row counts the launches of its dtype instance: x in bf16 for a
        # ":bf16" row (LayerNorm's gamma and beta in either dtype), else x
        # in fp32
        kernel, _, low = name.partition(":")
        by_path = {path: sum(n for (k, dts), n in counts.items()
                             if k == kernel and
                             (dts[0] == "bfloat16") == bool(low))
                   for path, counts in PATH_DTYPES.items()}
        by_path["rtc"] = 0
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if name in build_info:
            row["build"] = build_info[name]
    rtc_row["launches_by_path"] = {**{p: 0 for p in PATH_DTYPES},
                                   "rtc": rtc_row["launches"]}
    log(json.dumps({"kernels": list(kernels.values()) + [rtc_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
