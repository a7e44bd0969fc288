#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):

1. build   — nvcc builds every kernel of the serving, training and tuning
             paths from ``mxnet_tpu_torch/csrc`` (one process per source,
             in parallel, every legal tile instantiated), printing each
             source's seconds, ptxas's registers and spill bytes of the
             flash_fwd instances at head dim 64 and the tensor-core (HMMA)
             instructions cuobjdump finds in the flash_fwd library;
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
             Tq=384/Tk=1000 non-causal), max |diff| <= 1e-4 on dq, dk, dv;
             softmax at (4096, 768), (64, 50257) and ragged row counts, fp32
             max |diff| <= 1e-6, bf16 |diff| <= 8e-3 |ref| + 1e-7 (one
             ulp of the value; absolute 1e-2 would pass zeros at vocabulary
             width); then every kernel once at
             each tile of its legal set (flash (block_q, block_k) in
             {16, 32, 64}^2 at (4*12, 512, 64) causal + ids; LayerNorm and
             softmax block_rows in {1, 2, 4, 8, 16, 32} at (2000, 768)) at
             the same tolerances; kernel, plain and library (SDPA with a
             boolean mask, its autograd backward, F.layer_norm,
             torch.softmax) times, medians of CUDA-event timings;
3. serve   — GPT-2 small (12 x 768, 12 heads, vocab 50257, max_length
             1024, fp32, weights from a numpy seed loaded through
             ``params_from_mxnet_tpu``) served by ``DecodeEngine`` (8 slots,
             128-token pages, prefix cache), tuning off: 8 ragged prompts of
             16-500 tokens, 32 new tokens each, two sharing a 300-token
             prefix so the prefix-join program runs. Checks: the launch
             counts of the kernels against the engine's program runs, every
             launch at the default tile, each request's last-token prefill
             logits against the same weights on the CPU (relative max |diff|
             <= 1e-3), and the engine's greedy tokens against
             ``generate(use_cache=False)`` on the card up to the first near
             tie (top-2 logit margin < 1e-3);
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
train, tune, rtc); the last line is ``{"ok": true, "device": {...}}``.
"""
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
DEV = "cuda"


class SmokeError(Exception):
    pass


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
    ``kernel_name`` (launched once a call), from ``torch.profiler``
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
        if kernel_name in evt.key:
            us += getattr(evt, "device_time_total",
                          getattr(evt, "cuda_time_total", 0.0))
            n += evt.count
    if n != reps:
        log(f"[profiler] {kernel_name}: {n} kernel records for {reps} calls")
    return us / n / 1e3 if us > 0 else None


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
    from mxnet_tpu_torch.ops import _build

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
        if name == "flash_fwd":
            _flash_fwd_build_report(entries, libs["flash_fwd"])


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


_FWD_ENTRY = re.compile(
    r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E")


def _flash_fwd_build_report(entries, lib):
    """ptxas's registers and spill bytes of the flash_fwd instances at head
    dim 64, and the tensor-core (HMMA) instructions cuobjdump finds in the
    built library, where the toolkit has cuobjdump."""
    from pathlib import Path

    from mxnet_tpu_torch.ops import _build

    for entry, regs, spill in entries:
        m = _FWD_ENTRY.search(entry or "")
        if m and m.group(2) == "64":
            dtype, _, bq, bk = m.groups()
            log(f"[build]   flash_fwd {'fp32' if dtype == 'f' else 'bf16'} "
                f"D=64 block_q={bq} block_k={bk}: {regs} registers; {spill}")
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        log(f"[build]   flash_fwd: no cuobjdump beside nvcc ({tool}): the "
            f"tensor-core instructions are not counted")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = re.findall(r"\bHMMA\.\S+", sass)
    log(f"[build]   flash_fwd library: {len(hmma)} tensor-core (HMMA) "
        f"instructions, {sorted(set(hmma))}, in "
        f"{sass.count('Function : ')} kernel instances")
    check(hmma, "flash_fwd: no tensor-core instruction in the library")


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


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    rng = onp.random.RandomState(SEED)
    results = {}

    results["flash_fwd"] = _flash_fwd_rows(rng, dev)

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
        lib_ms = time_ms(lambda: F.layer_norm(x, (d,), g, b, 1e-5))
        bms, by = bound_ms(4 * (2 * rows * d + 2 * d), 8 * rows * d)
        log(f"[kernels] layer_norm rows={rows} d={d}: max|diff| {err:.3g};"
            f" kernel {ms:.4f} ms (device {dev_ms}), plain {plain_ms:.4f} "
            f"ms, F.layer_norm {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        if rows == 2048:
            main = (ms, plain_ms, lib_ms, bms, by, dev_ms)
    results["layer_norm"] = {
        "name": "layer_norm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/layer_norm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:866",
        "max_abs_err": ln_err, "ms": main[0], "plain_ms": main[1],
        "library_ms": main[2], "bound_ms": main[3], "bound_by": main[4],
        "device_ms": main[5],
        "shape": "x (4*512, 768) fp32, gamma/beta (768,) fp32"}
    results.update(_flash_bwd_rows(rng, dev))
    results["softmax"] = _softmax_row(rng, dev)
    _every_tile(rng, dev)
    return results


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
    and (48, 512, 64) bf16 stand in it under "more"."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    err = 0.0
    rows = {}
    for Tq, Tk, causal, seg, dtype in [(128, 128, True, True, f32),
                                       (384, 384, True, True, f32),
                                       (512, 512, True, True, f32),
                                       (1000, 1000, True, True, f32),
                                       (1024, 1024, True, True, f32),
                                       (384, 1000, False, False, f32),
                                       (512, 512, True, True, bf16)]:
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
        if seg:
            check(float(out[B - 1, :, 0].float().abs().max()) == 0.0,
                  f"{what}: the fully masked row is not zero")
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        sdpa_mask = mask[:, None]

        def kernel():
            ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)

        def sdpa():
            F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                           scale=scale)

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
        if seg and Tq == Tk and Tq in (512, 1024):
            rows[(Tq, dtype)] = {
                "ms": ms, "graph_ms": g_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_graph_ms": lib_g_ms, "bound_ms": bms,
                "bound_by": by, "cuda_core_bound_ms": core_ms,
                "shape": f"q/k/v ({B}*{H}, {Tq}, {D}) "
                         f"{'fp32' if dtype == f32 else 'bf16'}, causal + "
                         f"segment ids"}
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "mxnet_tpu/ops/pallas_kernels.py:163",
           "max_abs_err": err, "design": FWD_DESIGN}
    row.update(rows[(512, f32)])
    row["more"] = [rows[(1024, f32)], rows[(512, bf16)]]
    return row


def _softmax_row(rng, dev):
    """The softmax kernel against its plain version: GPT-2 width and
    vocabulary width, f32 and bf16, ragged row counts; times at
    (4096, 768) f32 give the JSON row."""
    import torch

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    err = 0.0
    main = None
    for rows, d in ((4096, 768), (64, 50257), (1, 768), (1001, 768)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(rows, d).astype("float32")).to(
                dev, dtype)
            out = ck.softmax_cuda(x)
            ref = ck.softmax_plain(x)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            e = float(diff.max())
            if dtype == torch.float32:
                check(e <= SOFTMAX_TOL, f"softmax ({rows}, {d}) fp32: max "
                      f"|diff| {e:.3g} > {SOFTMAX_TOL}")
            else:
                # relative: at vocabulary width a value is ~2e-5, so an
                # absolute limit would pass a kernel that wrote zeros
                over = float((diff - BF16_RTOL * ref.float().abs()).max())
                check(over <= BF16_ATOL,
                      f"softmax ({rows}, {d}) bf16: |diff| exceeds "
                      f"{BF16_RTOL} |ref| + {BF16_ATOL} by {over:.3g}")
            if dtype == torch.float32:
                err = max(err, e)
            if dtype != torch.float32 or rows not in (4096, 64):
                log(f"[kernels] softmax rows={rows} d={d} {dtype}: max|diff|"
                    f" {e:.3g}")
                continue

            def kernel():
                ck.softmax_cuda(x)

            ms = time_ms(kernel)
            dev_ms = device_ms(kernel, "softmax_kernel")
            plain_ms = time_ms(lambda: ck.softmax_plain(x))
            lib_ms = time_ms(lambda: torch.softmax(x, dim=-1))
            bms, by = bound_ms(2 * rows * d * 4, 4 * rows * d)
            log(f"[kernels] softmax rows={rows} d={d} fp32: max|diff| "
                f"{e:.3g}; kernel {ms:.4f} ms (device {dev_ms}), plain "
                f"{plain_ms:.4f} ms, torch.softmax {lib_ms:.4f} ms, bound "
                f"{bms:.5f} ms ({by})")
            if rows == 4096:
                main = (ms, plain_ms, lib_ms, bms, by, dev_ms)
    return {"name": "softmax", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/softmax.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:971",
            "max_abs_err": err, "ms": main[0], "plain_ms": main[1],
            "library_ms": main[2], "bound_ms": main[3], "bound_by": main[4],
            "device_ms": main[5], "shape": "x (4096, 768) fp32"}


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
                time_ms(lambda: ck.flash_bwd_dkv_cuda(*args), reps=20,
                        rounds=3),
                time_ms(lambda: ck.flash_bwd_dq_cuda(*args), reps=20,
                        rounds=3), e_fwd, e_bwd]
    for (bq, bk), (f, dkv, dq, e_fwd, e_bwd) in times.items():
        log(f"[kernels] tile block_q={bq} block_k={bk} at (48, 512, 64) "
            f"causal + ids: max|diff| fwd {e_fwd:.3g}, bwd {e_bwd:.3g}; ms "
            f"flash_fwd {f:.4f} (graph), flash_bwd_dkv {dkv:.4f}, "
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


def _flash_bwd_rows(rng, dev):
    """The two flash-attention backward kernels against the plain backward
    at GPT-2 training shapes; the training shape (4*12, 1024, 64) causal
    gives the JSON rows."""
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import cuda_kernels as ck

    B, H, D = 4, 12, 64
    scale = 1.0 / D ** 0.5
    err = {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    rows = {}
    for Tq, Tk, causal, seg in [(1024, 1024, True, False),
                                (512, 512, True, True),
                                (384, 384, True, True),
                                (1000, 1000, True, True),
                                (384, 1000, False, False)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        g = torch.from_numpy(rng.randn(B, H, Tq, D).astype("float32")) \
            .to(dev)
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        dq, dk, dv = ck.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                       causal)
        rq, rk, rv = ck.attention_bwd_plain(q, k, v, out, lse, g, qs, ks,
                                            scale, causal)
        torch.cuda.synchronize()
        e_dkv = max(float((dk - rk).abs().max()),
                    float((dv - rv).abs().max()))
        e_dq = float((dq - rq).abs().max())
        check(max(e_dkv, e_dq) <= FLASH_TOL,
              f"flash_bwd T=({Tq},{Tk}) causal={causal} seg={seg}: max "
              f"|diff| dk/dv {e_dkv:.3g}, dq {e_dq:.3g} > {FLASH_TOL}")
        if seg:
            check(float(dq[B - 1, :, 0].abs().max()) == 0.0,
                  "flash_bwd: the fully masked row has a gradient")
        err["flash_bwd_dkv"] = max(err["flash_bwd_dkv"], e_dkv)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], e_dq)
        delta = (g * out).sum(dim=-1)
        args = (q, k, v, g, lse, delta, qs, ks, scale, causal)
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        plain_ms = time_ms(lambda: ck.attention_bwd_plain(
            q, k, v, out, lse, g, qs, ks, scale, causal), reps=10)
        # the library's backward: autograd through SDPA with the same
        # boolean mask, less SDPA's forward alone
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_mask = mask[:, None]

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg,
                                               attn_mask=sdpa_mask,
                                               scale=scale)
            torch.autograd.grad(o, (qg, kg, vg), g)

        lib_ms = time_ms(lib_fwd_bwd, reps=20) - time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=scale), reps=20)
        n_in = 4 * (q.numel() + k.numel() + v.numel() + g.numel()
                    + lse.numel() + delta.numel()) + (
            4 * (qs.numel() + ks.numel()) if seg else 0)
        for name, fn, n_out, flops_per_pair in (
                ("flash_bwd_dkv", ck.flash_bwd_dkv_cuda, 2 * k.numel(), 8),
                ("flash_bwd_dq", ck.flash_bwd_dq_cuda, q.numel(), 6)):
            ms = time_ms(lambda: fn(*args))
            dev_ms = device_ms(lambda: fn(*args), name + "_kernel")
            bms, by, core_ms = attention_bound_ms(
                n_in + 4 * n_out, flops_per_pair * D * pairs, torch.float32)
            log(f"[kernels] {name} B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
                f"causal={causal} seg={seg}: max|diff| "
                f"{e_dkv if name.endswith('dkv') else e_dq:.3g}; kernel "
                f"{ms:.4f} ms (device {dev_ms}), bound {bms:.4f} ms ({by}, "
                f"3xTF32 tensor cores; CUDA-core bound {core_ms:.4f} ms), "
                f"{pairs} visible pairs")
            if (Tq, Tk) == (1024, 1024):
                rows[name] = (ms, plain_ms, lib_ms, bms, by, dev_ms, core_ms)
        log(f"[kernels] flash_bwd plain (dq, dk, dv together) {plain_ms:.4f}"
            f" ms; SDPA backward (autograd.grad through "
            f"scaled_dot_product_attention with the boolean mask, less its "
            f"forward) {lib_ms:.4f} ms")
    results = {}
    for name, line in (("flash_bwd_dkv", 529), ("flash_bwd_dq", 587)):
        ms, plain_ms, lib_ms, bms, by, dev_ms, core_ms = rows[name]
        results[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "cuda_core_bound_ms": core_ms, "device_ms": dev_ms,
            "shape": "q/k/v/g (4*12, 1024, 64) fp32, causal; plain and "
                     "library times cover dq, dk and dv together"}
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


def phase_serve():
    import torch

    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    max_new = MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, arrays = serve_model()
    n_params = sum(int(a.size) for a in arrays.values())
    log(f"[serve] gpt2_small: {len(arrays)} tensors, {n_params} parameters "
        f"from numpy default_rng({SEED}) in {time.perf_counter() - t0:.1f} s")

    eng = DecodeEngine(model, **SERVE_ARGS)
    eng.warmup()
    ck.reset_launch_counts()
    reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
    counts = ck.launch_counts()
    st = eng.stats()
    eng.close()
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
    log(f"[serve] kernel launches on the path: {counts}")

    check(all(len(o) == max_new for o in outs), "a request came up short")
    check(kinds["prefill_ext"] >= 1 and st["prefix_hit_tokens"] > 0,
          f"the prefix-join family did not run: {kinds}, "
          f"{st['prefix_hit_tokens']} hit tokens")
    check(counts["flash_fwd"] == 12 * kinds["prefill"],
          f"flash_fwd launches {counts['flash_fwd']} != 12 x "
          f"{kinds['prefill']} plain prefills")
    n_runs = st["prefills"] + st["ticks"]
    check(counts["layer_norm"] == 25 * n_runs,
          f"layer_norm launches {counts['layer_norm']} != 25 x {n_runs} "
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
    rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    log(f"[serve] prefill last-token logits, card vs CPU: relative max "
        f"|diff| {rel:.3g} (limit {LOGIT_RTOL})")
    check(rel <= LOGIT_RTOL, f"card vs CPU logits differ: {rel:.3g}")

    # -- greedy tokens: the engine against naive generation on the card ----
    ties = []
    for i, ((p, _), got) in enumerate(zip(reqs, outs)):
        want = model.generate(p, max_new_tokens=max_new, use_cache=False,
                              window=len(p) + max_new)[len(p):]
        seq = torch.tensor([p + want], dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            logits = model(seq)[0, len(p) - 1:len(p) + max_new - 1]
        top = torch.topk(logits, 2, dim=-1).values
        margins = (top[:, 0] - top[:, 1]).tolist()
        n = next((j for j, m in enumerate(margins) if m < NEAR_TIE),
                 max_new)
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
    return counts, agree




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


def make_trainer(model):
    """AdamW through ``gluon.Trainer``: peak lr TRAIN_LR after TRAIN_WARMUP
    linear warm-up steps, then a cosine down to a tenth of it at the last
    step; beta2 0.95 and weight decay 0.01 (GPT-3's settings)."""
    from mxnet_tpu_torch import lr_scheduler
    from mxnet_tpu_torch.gluon import Trainer

    sched = lr_scheduler.CosineScheduler(
        max_update=TRAIN_STEPS, base_lr=TRAIN_LR, final_lr=TRAIN_LR / 10,
        warmup_steps=TRAIN_WARMUP)
    return Trainer(model.collect_params(), "adamw",
                   {"learning_rate": TRAIN_LR, "beta2": 0.95, "wd": 0.01,
                    "lr_scheduler": sched})


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
    counts = ck.launch_counts()
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
    want = {"flash_fwd": 12, "flash_bwd_dkv": 12, "flash_bwd_dq": 12,
            "layer_norm": 25, "softmax": 0}
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != want]
    check(not bad, f"launches per step: step {bad[:1]} != {want}")
    check_default_tiles("train")
    return counts


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
        eng.warmup()
        m1, meas1 = n("tune.cache_misses"), n("tune.measurements")
        log(f"[tune] fresh engine warmup after preload: "
            f"{tune.status()['entries']} entries, {n('tune.cache_hits') - h0}"
            f" hits, {m1 - m0} misses")
        check(m1 == m0, f"{m1 - m0} cache misses after the preload")
        lib0 = ck.library_counts()
        reqs, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        lib = {f: c - lib0[f] for f, c in ck.library_counts().items()}
        check(n("tune.measurements") == meas1,
              "the serving engine measured candidates online")
        check(n("tune.cache_misses") == m1, "cache misses while serving")
        n_tok = sum(len(o) for o in outs)
        med = {f: statistics.median(x) for f, x in fam_ms.items() if x}
        log(f"[tune] tuned engine: {len(reqs)} requests, {n_tok} tokens in "
            f"{serve_s:.3f} s ({n_tok / serve_s:.1f} tokens/s); median ms "
            f"{ {f: round(v, 3) for f, v in med.items()} }; library-lowering"
            f" calls while serving {lib}")
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"request {i}: tuned tokens differ from the untuned "
                  f"engine's before step {upto}: {got} vs {want}")
        log(f"[tune] tuned engine tokens == untuned engine tokens up to "
            f"each request's first near tie")
        counts = ck.launch_counts()
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
        eng.warmup()
        lib0 = ck.library_counts()["layer_norm"]
        _, outs, serve_s, fam_ms = drive_engine(eng, model)
        eng.close()
        for i, (got, (want, upto)) in enumerate(zip(outs, agree)):
            check(got[:upto] == want[:upto],
                  f"[tune A/B] {variant}: request {i} differs from the "
                  f"untuned engine before step {upto}")
        tick = statistics.median(fam_ms["decode"])
        pre = statistics.median(fam_ms["prefill"])
        n_tok = sum(len(o) for o in outs)
        log(f"[tune A/B] {variant}: decode tick median {tick:.3f} ms "
            f"({len(fam_ms['decode'])} ticks), prefill median {pre:.3f} ms, "
            f"{n_tok / serve_s:.1f} tokens/s, F.layer_norm calls "
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
    # fp32 parity phases: full-precision matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    for var in ("MXTPU_TUNE", "MXTPU_FLASH_BLOCK_Q", "MXTPU_FLASH_BLOCK_K"):
        os.environ.pop(var, None)            # phases 1-4 run untuned
    try:
        t0 = time.perf_counter()
        phase_build()
        kernels = phase_kernels()
        serve_counts, agree = phase_serve()
        train_counts = phase_train(smi_line)
        tune_counts, _ = phase_tune(agree)
        rtc_row = phase_rtc()
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — every failure ends the run non-zero
        traceback.print_exc()
        log("chip_smoke: FAIL")
        return 1
    log(smi_line)
    for name, row in kernels.items():
        by_path = {"serve": serve_counts[name], "train": train_counts[name],
                   "tune": tune_counts[name], "rtc": 0}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    rtc_row["launches_by_path"] = {"serve": 0, "train": 0, "tune": 0,
                                   "rtc": rtc_row["launches"]}
    log(json.dumps({"kernels": list(kernels.values()) + [rtc_row]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
