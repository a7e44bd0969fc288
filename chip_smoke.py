#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final line):

1. build   — nvcc builds every kernel of the serving and training paths
             from ``mxnet_tpu_torch/csrc`` (one process per source, in
             parallel);
2. kernels — each kernel's wrapper against its plain PyTorch version on
             the card, fp32, inputs from a numpy seed: flash-attention
             forward at GPT-2 prefill shapes (causal + segment ids with
             right-padded tails and a fully masked row; Tq != Tk
             non-causal), max |diff| <= 1e-4 on out and LSE; LayerNorm at
             (rows, 768), max |diff| <= 1e-5; the two flash-attention
             backward kernels (dK/dV, dQ) at GPT-2 training shapes (4*12,
             1024, 64) causal, 512 with padding ids and a fully masked
             row, ragged 384 and 1000, Tq=384/Tk=1000 non-causal), max
             |diff| <= 1e-4 on dq, dk, dv; kernel, plain and library
             (SDPA with a boolean mask, its autograd backward,
             F.layer_norm) times, medians of CUDA-event timings;
3. serve   — GPT-2 small (12 x 768, 12 heads, vocab 50257, max_length
             1024, fp32, weights from a numpy seed loaded through
             ``params_from_mxnet_tpu``) served by ``DecodeEngine`` (8 slots,
             128-token pages, prefix cache): 8 ragged prompts of 16-500
             tokens, 32 new tokens each, two sharing a 300-token prefix so
             the prefix-join program runs. Checks: the launch counts of the
             kernels against the engine's program runs, each request's
             last-token prefill logits against the same weights on the
             CPU (relative max |diff| <= 1e-3), and the engine's greedy
             tokens against ``generate(use_cache=False)`` on the card up to
             the first near tie (top-2 logit margin < 1e-3);
4. train   — GPT-2 small (the same width and depth, GPT-2's N(0, 0.02)
             initialisation from a numpy seed, loaded through
             ``params_from_mxnet_tpu``) trained through
             ``autograd.record`` / ``autograd.backward`` /
             ``gluon.Trainer("adamw").step``: one step's gradients of every
             parameter at B=2, T=128 (one row right-padded through
             ``valid_length``, dropout 0) against the same weights on the
             CPU (relative max |diff| <= 1e-3); then 30 steps at B=4,
             T=1024 (AdamW with warm-up and a cosine schedule) with
             dropout 0.1 from ``mxnet_tpu_torch.random`` on a
             cyclic-sequence task made from the seed, whose loss must fall
             below half its first value, with 12 launches each of the
             flash forward, dK/dV and dQ kernels and 25 LayerNorm launches
             in every step; prints step ms, training tokens/s and peak
             device memory.

The lines before the last give the card's name and power limit and a JSON
object of every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as onp

SEED = 0
PEAK_FP32_FLOPS = 67e12    # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FLASH_TOL = 1e-4
LN_TOL = 1e-5
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
    """Device time per call of the CUDA kernels whose name contains
    ``kernel_name``, from ``torch.profiler`` (CUPTI); None when the
    profiler records no device time for them on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            us += getattr(evt, "device_time_total",
                          getattr(evt, "cuda_time_total", 0.0))
    return us / reps / 1e3 if us > 0 else None


def bound_ms(n_bytes, n_flops):
    """Least time on the card: bytes at the memory rate or operations at
    the fp32 peak, whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for name, cmd, secs, report in _build.build_log:
        log(f"[build] {name}: {secs:.2f} s: {' '.join(cmd)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


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
    B, H, D = 4, 12, 64
    results = {}

    # -- flash-attention forward ------------------------------------------
    flash_err = 0.0
    main = None
    for Tq, Tk, causal, seg in [(128, 128, True, True),
                                (384, 384, True, True),
                                (512, 512, True, True),
                                (1000, 1000, True, True),
                                (384, 1000, False, False)]:
        q, k, v, qs, ks = _flash_inputs(rng, dev, B, H, Tq, Tk, D, seg)
        scale = 1.0 / D ** 0.5
        out, lse = ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
        ref, ref_lse = ck.attention_plain(q, k, v, scale, causal, qs, ks)
        torch.cuda.synchronize()
        err = max(float((out - ref).abs().max()),
                  float((lse - ref_lse).abs().max()))
        check(err <= FLASH_TOL,
              f"flash_fwd T=({Tq},{Tk}) causal={causal}: max |diff| "
              f"{err:.3g} > {FLASH_TOL}")
        if seg:
            check(float(out[B - 1, :, 0].abs().max()) == 0.0,
                  "flash_fwd: the fully masked row is not zero")
        flash_err = max(flash_err, err)
        mask, pairs = _visible_pairs(qs, ks, B, H, Tq, Tk, causal)
        sdpa_mask = mask[:, None]
        def kernel():
            ck.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)

        ms = time_ms(kernel)
        dev_ms = device_ms(kernel, "flash_fwd_kernel")
        plain_ms = time_ms(lambda: ck.attention_plain(q, k, v, scale,
                                                      causal, qs, ks))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, scale=scale))
        n_bytes = 4 * (q.numel() + k.numel() + v.numel() + out.numel()
                       + lse.numel()) + (4 * (qs.numel() + ks.numel())
                                         if seg else 0)
        bms, by = bound_ms(n_bytes, 4 * D * pairs)
        log(f"[kernels] flash_fwd B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
            f"causal={causal} seg={seg}: max|diff| {err:.3g}; kernel "
            f"{ms:.4f} ms (device {dev_ms}), plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}, {pairs} visible "
            f"pairs)")
        if (Tq, Tk) == (512, 512):
            main = (ms, plain_ms, lib_ms, bms, by, dev_ms)
    results["flash_fwd"] = {
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:163",
        "max_abs_err": flash_err, "ms": main[0], "plain_ms": main[1],
        "library_ms": main[2], "bound_ms": main[3], "bound_by": main[4],
        "device_ms": main[5],
        "shape": "q/k/v (4*12, 512, 64) fp32, causal + segment ids"}

    # -- fused LayerNorm ----------------------------------------------------
    d = 768
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
    return results


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
            bms, by = bound_ms(n_in + 4 * n_out, flops_per_pair * D * pairs)
            log(f"[kernels] {name} B*H={B * H} Tq={Tq} Tk={Tk} D={D} "
                f"causal={causal} seg={seg}: max|diff| "
                f"{e_dkv if name.endswith('dkv') else e_dq:.3g}; kernel "
                f"{ms:.4f} ms (device {dev_ms}), bound {bms:.4f} ms ({by}, "
                f"{pairs} visible pairs)")
            if (Tq, Tk) == (1024, 1024):
                rows[name] = (ms, plain_ms, lib_ms, bms, by, dev_ms)
        log(f"[kernels] flash_bwd plain (dq, dk, dv together) {plain_ms:.4f}"
            f" ms; SDPA backward (autograd.grad through "
            f"scaled_dot_product_attention with the boolean mask, less its "
            f"forward) {lib_ms:.4f} ms")
    results = {}
    for name, line in (("flash_bwd_dkv", 529), ("flash_bwd_dq", 587)):
        ms, plain_ms, lib_ms, bms, by, dev_ms = rows[name]
        results[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"mxnet_tpu/ops/pallas_kernels.py:{line}",
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "device_ms": dev_ms,
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


def phase_serve():
    import torch

    from mxnet_tpu_torch import params_from_mxnet_tpu
    from mxnet_tpu_torch.gluon.model_zoo import gpt2_small
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serve.decode import DecodeEngine

    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    model = gpt2_small(dropout=0.0)                # the GPU: no device arg
    check(model.device.type == "cuda", f"model on {model.device}")
    shapes = {n: tuple(p.shape) for n, p in model.collect_params().items()}
    t0 = time.perf_counter()
    arrays = numpy_weights(shapes, SEED)
    model.load_dict(params_from_mxnet_tpu(arrays, model))
    n_params = sum(int(onp.prod(s)) for s in shapes.values())
    log(f"[serve] gpt2_small: {len(shapes)} tensors, {n_params} parameters "
        f"from numpy default_rng({SEED}) in {time.perf_counter() - t0:.1f} s")

    eng = DecodeEngine(model, num_slots=8, max_len=1024, max_prompt_len=512,
                       prefill_batch=4, page_tokens=128, prefix_cache=True)
    eng.warmup()
    # per-family device time: the engine syncs right after each run, so a
    # synchronize after the call adds nothing to what it waits for
    fam_ms = {"prefill": [], "prefill_ext": [], "decode": []}
    run = eng.programs.run

    def timed_run(key, datas):
        t = time.perf_counter()
        outs = run(key, datas)
        torch.cuda.synchronize()
        fam_ms[key[0]].append((time.perf_counter() - t) * 1e3)
        return outs

    eng.programs.run = timed_run

    rng = onp.random.RandomState(SEED + 1)
    prompts, first, second = make_prompts(rng, model.vocab_size)
    ck.reset_launch_counts()
    t_serve = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts[:3]]
    s_first = eng.submit(first, max_new_tokens=max_new)
    streams += [eng.submit(p, max_new_tokens=max_new) for p in prompts[3:]]
    deadline = time.perf_counter() + 300
    while not s_first.tokens:        # the tree holds a prompt once prefilled
        check(time.perf_counter() < deadline, "first token never arrived")
        check(not s_first.done or s_first.tokens, "shared request failed")
        time.sleep(0.001)
    s_second = eng.submit(second, max_new_tokens=max_new)
    reqs = list(zip(prompts, streams)) + [(first, s_first),
                                          (second, s_second)]
    outs = [s.result(timeout=600) for _, s in reqs]
    serve_s = time.perf_counter() - t_serve
    counts = ck.launch_counts()
    st = eng.stats()
    eng.programs.run = run
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
    return counts


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
            "layer_norm": 25}
    bad = [(i, ps) for i, ps in enumerate(per_step) if ps != want]
    check(not bad, f"launches per step: step {bad[:1]} != {want}")
    return counts


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
    try:
        t0 = time.perf_counter()
        phase_build()
        kernels = phase_kernels()
        serve_counts = phase_serve()
        train_counts = phase_train(smi_line)
        log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 — every failure ends the run non-zero
        traceback.print_exc()
        log("chip_smoke: FAIL")
        return 1
    log(smi_line)
    for name, row in kernels.items():
        row["launches"] = serve_counts[name] + train_counts[name]
        row["launches_by_path"] = {"serve": serve_counts[name],
                                   "train": train_counts[name]}
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
