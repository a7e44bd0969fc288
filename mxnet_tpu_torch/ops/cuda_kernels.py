"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py`` for its five TPU kernels:

- :func:`flash_attention` — the flash-attention forward
  (``csrc/flash_fwd.cu``, replacing ``_flash_fwd_kernel``, :163) and, as
  its autograd backward, the two backward kernels (``csrc/flash_bwd.cu``,
  replacing ``_flash_bwd_dkv_kernel``, :529, and ``csrc/flash_bwd_dq.cu``,
  replacing ``_flash_bwd_dq_kernel``, :587);
- :func:`fused_layer_norm` — row-wise LayerNorm (``csrc/layer_norm.cu``,
  replacing ``_ln_kernel``, :866);
- :func:`fused_softmax` — last-axis softmax (``csrc/softmax.cu``, replacing
  ``_softmax_kernel``, :971), with the closed-form backward.

Each wrapper takes its plain version (:func:`attention_plain`,
:func:`attention_bwd_plain`, :func:`layer_norm_plain`,
:func:`softmax_plain`, ports of ``_attention_reference``, the backward
identities at :519-527, ``_ln_reference`` and ``_softmax_kernel``'s math)
only for tensors that lie on the CPU. For CUDA tensors it launches its
kernel or raises: nothing falls back from a failed build or launch. Each
launch adds one to the kernel's counter (``flash_fwd_launches``,
``flash_bwd_dkv_launches``, ``flash_bwd_dq_launches``,
``layer_norm_launches``, ``softmax_launches``), to the count of its tile
(:func:`tile_counts`) and to the count of its operands' dtypes
(:func:`dtype_counts`), so a run can show that its path went through the
kernels, with which tiles and at which dtype instances.

Tiles are call parameters, as in the reference (:39-132). ``None`` resolves
per call through the tuning tier (:mod:`mxnet_tpu_torch.tune`): with tuning
off the env-default tiles (:func:`flash_block_q`, :func:`flash_block_k`,
4 rows for the row kernels); with ``MXTPU_TUNE=1`` the persisted winner for
the call's shape bucket, or the library lowering (``"xla"``:
``scaled_dot_product_attention``, ``torch.autograd.grad`` through it,
``F.layer_norm``, ``torch.softmax``) on a miss or where it won. A wrapper
takes the library lowering only on CUDA tensors and only when the tuning
tier chose it, and counts every such call (:func:`library_counts`). A value
pins the tile. The two attention families resolve separately: the forward
as ``flash_fwd``, its backward as ``flash_bwd``.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..tune import cache as _tune
from . import _build

__all__ = ["flash_attention", "fused_layer_norm", "fused_softmax",
           "attention_plain", "attention_bwd_plain", "layer_norm_plain",
           "softmax_plain", "flash_fwd_cuda", "flash_bwd_cuda",
           "flash_bwd_dkv_cuda", "flash_bwd_dq_cuda", "layer_norm_cuda",
           "softmax_cuda", "flash_block_q", "flash_block_k", "FLASH_BLOCKS",
           "ROW_BLOCKS", "DEFAULT_BLOCK_ROWS", "launch_counts",
           "reset_launch_counts", "tile_counts", "dtype_counts",
           "library_counts"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128

# the legal tiles: query rows / keys of a flash tile, rows of a row-kernel
# block (one warp a row, so at most 32; the Pallas kernels' block_rows
# counted rows a grid step, up to 1024)
FLASH_BLOCKS = (16, 32, 64)
ROW_BLOCKS = (1, 2, 4, 8, 16, 32)
DEFAULT_BLOCK_ROWS = 4

# launches of each kernel since the last reset (plain ints; the wrappers
# below are their only writers)
flash_fwd_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_launches = 0
layer_norm_launches = 0
softmax_launches = 0
_tiles = {}       # (kernel, tile) -> launches, beside the counters above
_dtypes = {}      # (kernel, operand dtype names) -> launches
_library = {"flash_fwd": 0, "flash_bwd": 0, "layer_norm": 0, "softmax": 0}


def launch_counts():
    return {"flash_fwd": flash_fwd_launches,
            "flash_bwd_dkv": flash_bwd_dkv_launches,
            "flash_bwd_dq": flash_bwd_dq_launches,
            "layer_norm": layer_norm_launches,
            "softmax": softmax_launches}


def tile_counts():
    """Launches since the last reset by (kernel, tile): the tile is
    (block_q, block_k) for the flash kernels, (block_rows,) for the row
    kernels."""
    return dict(_tiles)


def dtype_counts():
    """Launches since the last reset by (kernel, dtypes): the operands'
    dtype names, ``("bfloat16",)`` for the flash kernels and the softmax,
    (x's, gamma's) for LayerNorm, e.g. ``("bfloat16", "float32")``."""
    return dict(_dtypes)


def library_counts():
    """Calls since the last reset that took the library lowering (the
    tuning tier's ``"xla"``), by kernel family."""
    return dict(_library)


def reset_launch_counts():
    global flash_fwd_launches, flash_bwd_dkv_launches, \
        flash_bwd_dq_launches, layer_norm_launches, softmax_launches
    flash_fwd_launches = 0
    flash_bwd_dkv_launches = 0
    flash_bwd_dq_launches = 0
    layer_norm_launches = 0
    softmax_launches = 0
    _tiles.clear()
    _dtypes.clear()
    for fam in _library:
        _library[fam] = 0


def _launched(name, tile, *dtypes):
    _tiles[(name, tile)] = _tiles.get((name, tile), 0) + 1
    key = (name, tuple(str(d).replace("torch.", "") for d in dtypes))
    _dtypes[key] = _dtypes.get(key, 0) + 1


# ---------------------------------------------------------------------------
# tiles: env defaults and per-call resolution through the tuning tier
# ---------------------------------------------------------------------------
def _validated_block_env(name, default) -> int:
    """A flash tile from env var ``name``, read per call (not at import),
    so tests and the tuner can vary it without reloading the module."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise MXNetError(
            f"{name}={raw!r} is not an integer; expected one of "
            f"{FLASH_BLOCKS}") from None
    if v not in FLASH_BLOCKS:
        raise MXNetError(
            f"{name}={v} is invalid: the flash kernels take tiles of "
            f"{FLASH_BLOCKS} rows")
    return v


def flash_block_q() -> int:
    """Default query tile (``MXTPU_FLASH_BLOCK_Q``, default 32) — the
    starting point the tuner measures against, not a frozen constant."""
    return _validated_block_env("MXTPU_FLASH_BLOCK_Q", 32)


def flash_block_k() -> int:
    """Default key tile (``MXTPU_FLASH_BLOCK_K``, default 32)."""
    return _validated_block_env("MXTPU_FLASH_BLOCK_K", 32)


def _flash_tile(name, block_q, block_k):
    bq = flash_block_q() if block_q is None else int(block_q)
    bk = flash_block_k() if block_k is None else int(block_k)
    if bq not in FLASH_BLOCKS or bk not in FLASH_BLOCKS:
        raise MXNetError(
            f"{name}: tile (block_q={bq}, block_k={bk}) is not in "
            f"{FLASH_BLOCKS}")
    return bq, bk


def _row_tile(name, block_rows):
    br = DEFAULT_BLOCK_ROWS if block_rows is None else int(block_rows)
    if br not in ROW_BLOCKS:
        raise MXNetError(
            f"{name}: block_rows={br} is not in {ROW_BLOCKS}")
    return br


# Device types whose calls resolve through the tuning tier. Only a CUDA call
# can launch a kernel or take the library lowering, so a CPU process logs no
# misses and moves no tune.* counter (the reference resolves only where
# Pallas runs). The CPU tests of the tuning loop add "cpu" to drive it
# through the plain versions.
_TUNED_DEVICES = ("cuda",)


def _resolve_attention_blocks(kernel, q, k, causal, seg):
    """(block_q, block_k) for this call, or None for the library lowering.

    ``kernel`` is ``"flash_fwd"`` or ``"flash_bwd"`` — the two are tuned
    independently (their blocks own opposite axes). With tuning off this
    returns the env-default tiles; with tuning on, a miss or a tuned
    kernel loss returns None (never silently slower)."""
    cfg = _tune.lookup(
        kernel, (kernel, q.shape, k.shape[2], q.dtype, causal, seg),
        lambda: _tune.key_attention(kernel, q.shape, k.shape, q.dtype,
                                    causal, seg))
    if cfg == "default":
        return flash_block_q(), flash_block_k()
    if cfg == "xla":
        return None
    return (int(cfg.get("block_q", flash_block_q())),
            int(cfg.get("block_k", flash_block_k())))


def _resolve_block_rows(kernel, rows, d, dtype):
    """block_rows for a row kernel (``"layer_norm"``/``"softmax"``), or 0
    for the library lowering."""
    cfg = _tune.lookup(kernel, (kernel, rows, d, dtype),
                       lambda: _tune.key_rows(kernel, rows, d, dtype))
    if cfg == "default":
        return DEFAULT_BLOCK_ROWS
    if cfg == "xla":
        return 0
    return int(cfg.get("block_rows", DEFAULT_BLOCK_ROWS))


def _stream_ptr(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise MXNetError(
                f"{name}: every operand must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise MXNetError(f"{name}: operands must be contiguous")


# ---------------------------------------------------------------------------
# flash attention: plain versions
# ---------------------------------------------------------------------------
def _visible(tq, tk, causal, q_seg, k_seg, device):
    """Boolean (B or 1, 1, Tq, Tk) mask of the visible (query, key) pairs —
    causal bottom-right and segment equality — or None when all are."""
    masked = None
    if causal:
        masked = torch.ones((tq, tk), dtype=torch.bool,
                            device=device).tril(tk - tq)[None, None]
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        masked = seg if masked is None else (masked & seg)
    return masked


def attention_plain(q, k, v, scale, causal, q_seg=None, k_seg=None):
    """Plain version of the flash-attention forward: the reference's
    ``_attention_reference`` (pallas_kernels.py:138-157) over (B, H, T, D)
    operands, plus the fp32 log-sum-exp (B, H, Tq, 1) the kernel returns.
    A fully masked query row yields zeros."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    masked = _visible(s.shape[-2], s.shape[-1], causal, q_seg, k_seg,
                      s.device)
    if masked is not None:
        s = torch.where(masked, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    if masked is not None:
        e = torch.where(masked, e, torch.zeros_like(e))
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = e / l
    out = torch.matmul(p.to(v.dtype), v)
    return out, m + torch.log(l)


def attention_bwd_plain(q, k, v, out, lse, g, q_seg, k_seg, scale, causal):
    """Plain version of the two flash-attention backward kernels: the
    reference's identities (pallas_kernels.py:519-527) over the whole score
    matrix, in fp32, with the forward's ``out`` and ``lse`` (B, H, Tq, 1):

        p = exp(s - lse), 0 where hidden;   Δ = rowsum(g ∘ out)
        dv = pᵀg;  ds = p (g vᵀ - Δ) scale;  dq = ds k;  dk = dsᵀq

    Returns (dq, dk, dv) in the operands' dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    masked = _visible(s.shape[-2], s.shape[-1], causal, q_seg, k_seg,
                      s.device)
    if masked is not None:
        p = torch.where(masked, p, torch.zeros_like(p))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# flash attention: the kernels
# ---------------------------------------------------------------------------
def _check_attention(name, q, k, v, q_seg, k_seg, *more):
    """Validate (B, H, T, D) operands for the flash kernels; returns
    (B, H, Tq, Tk, D)."""
    ops = [q, k, v, *more] + ([q_seg, k_seg] if q_seg is not None else [])
    _check_cuda(name, *ops)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"{name}: q, k, v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise MXNetError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not agree")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError(
            f"{name}: operands must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D > _MAX_HEAD_DIM or B * H > 65535:
        raise MXNetError(
            f"{name}: head dim {D} > {_MAX_HEAD_DIM} or B*H "
            f"{B * H} > 65535 is not supported by the kernel")
    if q_seg is not None and (
            q_seg.dtype != torch.int32 or k_seg.dtype != torch.int32
            or tuple(q_seg.shape) != (B, Tq) or tuple(k_seg.shape) != (B, Tk)):
        raise MXNetError(
            f"{name}: segment ids must be int32 (B, Tq) / (B, Tk)")
    return B, H, Tq, Tk, D


def _seg_ptrs(q_seg, k_seg):
    if q_seg is None:
        return None, None
    return q_seg.data_ptr(), k_seg.data_ptr()


def flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal, block_q=None,
                   block_k=None):
    """Launch ``csrc/flash_fwd.cu`` on contiguous (B, H, T, D) CUDA operands
    (float32 or bfloat16, D <= 128) with optional int32 (B, T) segment ids,
    at the tile (``block_q`` query rows a block, ``block_k`` keys a
    shared-memory tile; None: the env defaults). Returns (out (B, H, Tq, D)
    in q's dtype, lse (B, H, Tq, 1) float32)."""
    global flash_fwd_launches
    B, H, Tq, Tk, D = _check_attention("flash_attention", q, k, v, q_seg,
                                       k_seg)
    bq, bk = _flash_tile("flash_attention", block_q, block_k)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.load("flash_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            out.data_ptr(), lse.data_ptr(), B * H, H, Tq, Tk, D,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype], bq, bk,
            _stream_ptr(q))
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd_launches += 1
    _launched("flash_fwd", (bq, bk), q.dtype)
    return out, lse


def _check_bwd_stats(name, q, g, lse, delta):
    B, H, Tq, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype:
        raise MXNetError(
            f"{name}: g {tuple(g.shape)} {g.dtype} must match q "
            f"{tuple(q.shape)} {q.dtype}")
    for nm, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.numel() != B * H * Tq:
            raise MXNetError(
                f"{name}: {nm} must be float32 with B*H*Tq = {B * H * Tq} "
                f"values, got {t.dtype} {tuple(t.shape)}")


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale,
                       causal, block_q=None, block_k=None):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``. q, g (B, H, Tq, D)
    and k, v (B, H, Tk, D) contiguous on one CUDA device, one dtype
    (float32 or bfloat16, D <= 128); the forward's lse and Δ =
    rowsum(g ∘ out), float32 with B*H*Tq values; optional int32 (B, T)
    segment ids. A block owns ``block_k`` keys and loops over tiles of
    ``block_q`` queries (None: the env defaults). Returns (dk, dv) in k's
    dtype."""
    global flash_bwd_dkv_launches
    B, H, Tq, Tk, D = _check_attention("flash_bwd_dkv", q, k, v, q_seg,
                                       k_seg, g, lse, delta)
    _check_bwd_stats("flash_bwd_dkv", q, g, lse, delta)
    bq, bk = _flash_tile("flash_bwd_dkv", block_q, block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0 or Tq == 0:
        return dk.zero_(), dv.zero_()
    fn = _build.load("flash_bwd_dkv")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            dk.data_ptr(), dv.data_ptr(), B * H, H, Tq, Tk, D, float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], bq, bk, _stream_ptr(q))
    if rc != 0:
        raise MXNetError(
            f"flash_bwd_dkv kernel launch failed: CUDA error {rc}")
    flash_bwd_dkv_launches += 1
    _launched("flash_bwd_dkv", (bq, bk), q.dtype)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale, causal,
                      block_q=None, block_k=None):
    """Launch the dQ kernel of ``csrc/flash_bwd_dq.cu`` (operands as
    :func:`flash_bwd_dkv_cuda`). A block owns ``block_q`` queries and loops
    over tiles of ``block_k`` keys. Returns dq in q's dtype."""
    global flash_bwd_dq_launches
    B, H, Tq, Tk, D = _check_attention("flash_bwd_dq", q, k, v, q_seg,
                                       k_seg, g, lse, delta)
    _check_bwd_stats("flash_bwd_dq", q, g, lse, delta)
    bq, bk = _flash_tile("flash_bwd_dq", block_q, block_k)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or Tk == 0:
        return dq.zero_()
    fn = _build.load("flash_bwd_dq")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            dq.data_ptr(), B * H, H, Tq, Tk, D, float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], bq, bk, _stream_ptr(q))
    if rc != 0:
        raise MXNetError(
            f"flash_bwd_dq kernel launch failed: CUDA error {rc}")
    flash_bwd_dq_launches += 1
    _launched("flash_bwd_dq", (bq, bk), q.dtype)
    return dq


def flash_bwd_cuda(q, k, v, out, lse, g, q_seg, k_seg, scale, causal,
                   block_q=None, block_k=None):
    """The flash-attention backward on the card: Δ = rowsum(g ∘ out) in
    fp32 (one torch reduction, outside the kernels as in the reference,
    pallas_kernels.py:647-648), then the dK/dV and dQ kernels. Operands as
    :func:`flash_fwd_cuda`, plus the forward's ``out`` and ``lse`` and the
    output gradient ``g`` (B, H, Tq, D), all contiguous. Returns
    (dq, dk, dv) in the operands' dtype. The two kernel wrappers check the
    operands.

    ``block_q``/``block_k`` both None resolve the tile through the tuning
    tier as ``flash_bwd``; where it chooses the library lowering, the
    gradients come from ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` recomputed from q, k and v."""
    if out.shape != q.shape:
        raise MXNetError(
            f"flash_bwd: out {tuple(out.shape)} must match q "
            f"{tuple(q.shape)}")
    if block_q is None and block_k is None:
        _check_cuda("flash_bwd", q, k, v, g)
        blocks = _resolve_attention_blocks("flash_bwd", q, k, causal,
                                           q_seg is not None)
        if blocks is None:
            return _attention_bwd_library(q, k, v, g, q_seg, k_seg, scale,
                                          causal)
        block_q, block_k = blocks
    delta = (g.float() * out.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale,
                                causal, block_q, block_k)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale,
                           causal, block_q, block_k)
    return dq, dk, dv


def _sdpa(q, k, v, scale, causal, q_seg, k_seg):
    """``scaled_dot_product_attention`` with the boolean mask; returns
    (out, mask). A query row that sees no key gets zeros, as the kernel
    gives it: SDPA sees that row unmasked and its output is replaced."""
    mask = _visible(q.shape[2], k.shape[2], causal, q_seg, k_seg, q.device)
    if mask is None:
        return F.scaled_dot_product_attention(q, k, v, scale=scale), None
    seen = mask.any(dim=-1, keepdim=True)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask | ~seen,
                                         scale=scale)
    return torch.where(seen, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)), mask


def _attention_library(q, k, v, scale, causal, q_seg, k_seg,
                       return_lse=False):
    """The library lowering of the forward (the tuning tier's ``"xla"``);
    the LSE, where asked for, from ``torch.logsumexp`` of the masked
    scores."""
    _library["flash_fwd"] += 1
    out, mask = _sdpa(q, k, v, scale, causal, q_seg, k_seg)
    if not return_lse:
        return out, None
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return out, torch.logsumexp(s, dim=-1, keepdim=True).detach()


def _attention_bwd_library(q, k, v, g, q_seg, k_seg, scale, causal):
    """The library lowering of the backward: ``torch.autograd.grad``
    through SDPA with the boolean mask, recomputed from q, k and v."""
    _library["flash_bwd"] += 1
    with torch.enable_grad():
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out, _ = _sdpa(qs, ks, vs, scale, causal, q_seg, k_seg)
        return torch.autograd.grad(out, (qs, ks, vs), g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, scale, causal, blocks,
                bwd_blocks):
        out, lse = flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                  *blocks)
        ctx.mark_non_differentiable(lse)
        # out itself (contiguous, owned by the kernel) for Δ, never a view
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        ctx.scale, ctx.causal, ctx.bwd_blocks = scale, causal, bwd_blocks
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if torch.is_grad_enabled():
            # create_graph: the two backward kernels have no derivative of
            # their own, so a gradient that is to be differentiated again
            # cannot go through them (it would come back as zeros)
            raise MXNetError(
                "flash_attention: the backward kernels have no derivative; "
                "a gradient with create_graph=True (for a higher-order "
                "gradient) cannot go through them")
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        # the caller's merge of heads hands a transposed view: the kernels
        # read rows, so make it contiguous
        g = g_out.contiguous()
        if ctx.bwd_blocks is None:
            dq, dk, dv = _attention_bwd_library(q, k, v, g, q_seg, k_seg,
                                                ctx.scale, ctx.causal)
        else:
            dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, g, q_seg, k_seg,
                                        ctx.scale, ctx.causal,
                                        *ctx.bwd_blocks)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, q_segment_ids=None,
                    kv_segment_ids=None, return_lse=False, block_q=None,
                    block_k=None):
    """Fused attention over (B, H, T, D) operands (reference:
    pallas_kernels.py:310).

    ``q_segment_ids``/``kv_segment_ids`` are optional (B, T) int arrays:
    tokens attend only within equal ids; one side given alone is used for
    both. Causal masking is bottom-right aligned (query i sees keys
    <= i + Tk - Tq). Any Tq, Tk: the kernels mask the ragged edge
    themselves. ``return_lse`` also returns the fp32 log-sum-exp
    (B, H, Tq, 1). Differentiable in q, k, v: on the card the backward runs
    the two backward kernels; on the CPU autograd differentiates the plain
    version.

    ``block_q``/``block_k`` both None resolve the forward's tile through
    the tuning tier (``flash_fwd``); a value pins it (None beside it: the
    env default). Where autograd records a kernel call, the backward's tile
    resolves here too (``flash_bwd``), so the backward, which autograd runs
    on a thread of its own, uses the decision of the caller's thread (and
    its tuning overrides). On the CPU the tiles are inert and nothing
    resolves.
    """
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    if q_segment_ids is None:
        q_segment_ids = kv_segment_ids
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32)
        kv_segment_ids = kv_segment_ids.to(torch.int32)
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError(
            f"flash_attention: unsupported device {q.device}")
    seg = q_segment_ids is not None
    tuned = q.device.type in _TUNED_DEVICES
    if block_q is None and block_k is None and tuned:
        blocks = _resolve_attention_blocks("flash_fwd", q, k, causal, seg)
    else:
        blocks = _flash_tile("flash_attention", block_q, block_k)
    bwd_blocks = None
    if tuned and blocks is not None and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        bwd_blocks = _resolve_attention_blocks("flash_bwd", q, k, causal,
                                               seg)
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, s, causal, q_segment_ids,
                                   kv_segment_ids)
        return (out, lse) if return_lse else out
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.contiguous()
        kv_segment_ids = kv_segment_ids.contiguous()
    if blocks is None:
        out, lse = _attention_library(q, k, v, s, causal, q_segment_ids,
                                      kv_segment_ids, return_lse)
    else:
        out, lse = _FlashAttention.apply(q, k, v, q_segment_ids,
                                         kv_segment_ids, s, causal, blocks,
                                         bwd_blocks)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# fused layer norm
# ---------------------------------------------------------------------------
def layer_norm_plain(x, gamma, beta, eps):
    """Plain version of the fused LayerNorm: the reference's
    ``_ln_reference`` (pallas_kernels.py:904-910); keeps x's dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return ((x - mean) * inv * gamma + beta).to(x.dtype)


def layer_norm_cuda(x, gamma, beta, eps, block_rows=None):
    """Launch ``csrc/layer_norm.cu``: row LayerNorm over x's last axis,
    ``block_rows`` rows a block (None: 4). x contiguous float32/bfloat16 on
    CUDA; gamma/beta (d,) float32 or bfloat16. Returns a new tensor of x's
    shape and dtype."""
    global layer_norm_launches
    _check_cuda("fused_layer_norm", x, gamma, beta)
    br = _row_tile("fused_layer_norm", block_rows)
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(gamma.shape) != (d,) or \
            tuple(beta.shape) != (d,):
        raise MXNetError(
            f"fused_layer_norm: x {tuple(x.shape)} needs gamma/beta of "
            f"shape ({d},), got {tuple(gamma.shape)}, {tuple(beta.shape)}")
    if x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE or \
            beta.dtype != gamma.dtype:
        raise MXNetError(
            f"fused_layer_norm: unsupported dtypes x {x.dtype}, gamma "
            f"{gamma.dtype}, beta {beta.dtype}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    fn = _build.load("layer_norm")
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[gamma.dtype], br, _stream_ptr(x))
    if rc != 0:
        raise MXNetError(
            f"layer_norm kernel launch failed: CUDA error {rc}")
    layer_norm_launches += 1
    _launched("layer_norm", (br,), x.dtype, gamma.dtype)
    return out


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, block_rows):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return layer_norm_cuda(x, gamma, beta, eps, block_rows)

    @staticmethod
    def backward(ctx, g):
        # the vjp of the plain formula, as the reference's _fused_ln_bwd
        # (pallas_kernels.py:958-962)
        x, gamma, beta = ctx.saved_tensors
        if torch.is_grad_enabled():
            # create_graph: the vjp recorded on the saved inputs themselves,
            # so the gradient can be differentiated again, as the
            # reference's jnp vjp can
            need = ctx.needs_input_grad[:3]
            ins = [t for t, n in zip((x, gamma, beta), need) if n]
            got = iter(torch.autograd.grad(
                layer_norm_plain(x, gamma, beta, ctx.eps), ins, g,
                create_graph=True, allow_unused=True))
            return (*[next(got) if n else None for n in need], None, None)
        with torch.enable_grad():
            xs, gs, bs = (t.detach().requires_grad_() for t in
                          (x, gamma, beta))
            out = layer_norm_plain(xs, gs, bs, ctx.eps)
            gx, gg, gb = torch.autograd.grad(out, (xs, gs, bs), g)
        return gx, gg, gb, None, None


def _rows_of(x):
    d = x.shape[-1] if x.dim() else 0
    return (x.numel() // d if d else 0), d


def fused_layer_norm(x, gamma, beta, eps=1e-5, block_rows=None):
    """Row-wise LayerNorm over the last axis (reference:
    pallas_kernels.py:883). Differentiable: the kernel runs forward, the
    backward is the plain formula's vjp.

    ``block_rows=None`` resolves through the tuning tier (4 when tuning is
    off; the library lowering ``F.layer_norm`` where the tier chooses
    ``"xla"``); a value pins it. On the CPU it is inert and nothing
    resolves."""
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"fused_layer_norm: unsupported device {x.device}")
    if block_rows is None and x.device.type in _TUNED_DEVICES:
        rows, d = _rows_of(x)
        block_rows = _resolve_block_rows("layer_norm", rows, d, x.dtype)
    else:
        block_rows = _row_tile("fused_layer_norm", block_rows)
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    if block_rows == 0:
        _library["layer_norm"] += 1
        return F.layer_norm(x, x.shape[-1:], gamma.to(x.dtype),
                            beta.to(x.dtype), eps)
    return _FusedLayerNorm.apply(x, gamma, beta, eps, block_rows)


# ---------------------------------------------------------------------------
# fused softmax (last axis)
# ---------------------------------------------------------------------------
def softmax_plain(x):
    """Plain version of the fused softmax: ``_softmax_kernel``'s math
    (pallas_kernels.py:971-975) in fp32, cast back to x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_cuda(x, block_rows=None):
    """Launch ``csrc/softmax.cu``: softmax over x's last axis,
    ``block_rows`` rows a block (None: 4). x contiguous float32/bfloat16 on
    CUDA, any width. Returns a new tensor of x's shape and dtype."""
    global softmax_launches
    _check_cuda("fused_softmax", x)
    br = _row_tile("fused_softmax", block_rows)
    if x.dtype not in _DTYPE_CODE or x.dim() < 1:
        raise MXNetError(
            f"fused_softmax: x must be float32 or bfloat16 with at least "
            f"one axis, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    rows, d = _rows_of(x)
    if rows == 0:
        return out
    fn = _build.load("softmax")
    rc = fn(x.data_ptr(), out.data_ptr(), rows, d, _DTYPE_CODE[x.dtype], br,
            _stream_ptr(x))
    if rc != 0:
        raise MXNetError(f"softmax kernel launch failed: CUDA error {rc}")
    softmax_launches += 1
    _launched("softmax", (br,), x.dtype)
    return out


class _FusedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_rows):
        y = softmax_plain(x) if x.device.type == "cpu" else \
            softmax_cuda(x, block_rows)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # the closed form, as the reference's _fused_softmax_bwd
        # (pallas_kernels.py:1023-1025)
        (y,) = ctx.saved_tensors
        return (g - (g * y).sum(dim=-1, keepdim=True)) * y, None


def fused_softmax(x, block_rows=None):
    """Last-axis softmax (reference: pallas_kernels.py:978). Any width:
    the reference sends widths that are not a multiple of 128 to
    ``jax.nn.softmax``, the same function. Differentiable: the kernel runs
    forward, the backward is the closed form (g - Σ g·y)·y.

    ``block_rows=None`` resolves through the tuning tier (4 when tuning is
    off; the library lowering ``torch.softmax`` where the tier chooses
    ``"xla"``); a value pins it. On the CPU it is inert and nothing
    resolves."""
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"fused_softmax: unsupported device {x.device}")
    if block_rows is None and x.device.type in _TUNED_DEVICES:
        rows, d = _rows_of(x)
        block_rows = _resolve_block_rows("softmax", rows, d, x.dtype)
    else:
        block_rows = _row_tile("fused_softmax", block_rows)
    if x.device.type == "cuda":
        if block_rows == 0:
            _library["softmax"] += 1
            return torch.softmax(x, dim=-1)
        x = x.contiguous()
    return _FusedSoftmax.apply(x, block_rows)
