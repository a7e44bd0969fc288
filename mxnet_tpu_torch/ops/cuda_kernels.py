"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py`` for the four TPU kernels
the GPT training and serving paths run:

- :func:`flash_attention` — the flash-attention forward
  (``csrc/flash_fwd.cu``, replacing ``_flash_fwd_kernel``, :163) and, as
  its autograd backward, the two backward kernels (``csrc/flash_bwd.cu``,
  replacing ``_flash_bwd_dkv_kernel``, :529, and ``_flash_bwd_dq_kernel``,
  :587);
- :func:`fused_layer_norm` — row-wise LayerNorm (``csrc/layer_norm.cu``,
  replacing ``_ln_kernel``, :866).

Each wrapper takes its plain version (:func:`attention_plain`,
:func:`attention_bwd_plain`, :func:`layer_norm_plain`, ports of
``_attention_reference``, the backward identities at :519-527 and
``_ln_reference``) only for tensors that lie on the CPU. For CUDA tensors it
launches its kernel or raises: nothing falls back from a failed build or
launch. Each launch adds one to the kernel's counter (``flash_fwd_launches``,
``flash_bwd_dkv_launches``, ``flash_bwd_dq_launches``,
``layer_norm_launches``), so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "fused_layer_norm", "attention_plain",
           "attention_bwd_plain", "layer_norm_plain", "flash_fwd_cuda",
           "flash_bwd_cuda", "flash_bwd_dkv_cuda", "flash_bwd_dq_cuda",
           "layer_norm_cuda", "launch_counts", "reset_launch_counts"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128

# launches of each kernel since the last reset (plain ints; the wrappers
# below are their only writers)
flash_fwd_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_launches = 0
layer_norm_launches = 0


def launch_counts():
    return {"flash_fwd": flash_fwd_launches,
            "flash_bwd_dkv": flash_bwd_dkv_launches,
            "flash_bwd_dq": flash_bwd_dq_launches,
            "layer_norm": layer_norm_launches}


def reset_launch_counts():
    global flash_fwd_launches, flash_bwd_dkv_launches, \
        flash_bwd_dq_launches, layer_norm_launches
    flash_fwd_launches = 0
    flash_bwd_dkv_launches = 0
    flash_bwd_dq_launches = 0
    layer_norm_launches = 0


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


def flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal):
    """Launch ``csrc/flash_fwd.cu`` on contiguous (B, H, T, D) CUDA operands
    (float32 or bfloat16, D <= 128) with optional int32 (B, T) segment ids.
    Returns (out (B, H, Tq, D) in q's dtype, lse (B, H, Tq, 1) float32)."""
    global flash_fwd_launches
    B, H, Tq, Tk, D = _check_attention("flash_attention", q, k, v, q_seg,
                                       k_seg)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.load("flash_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            out.data_ptr(), lse.data_ptr(), B * H, H, Tq, Tk, D,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _stream_ptr(q))
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd_launches += 1
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
                       causal):
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu``. q, g (B, H, Tq, D)
    and k, v (B, H, Tk, D) contiguous on one CUDA device, one dtype
    (float32 or bfloat16, D <= 128); the forward's lse and Δ =
    rowsum(g ∘ out), float32 with B*H*Tq values; optional int32 (B, T)
    segment ids. Returns (dk, dv) in k's dtype."""
    global flash_bwd_dkv_launches
    B, H, Tq, Tk, D = _check_attention("flash_bwd_dkv", q, k, v, q_seg,
                                       k_seg, g, lse, delta)
    _check_bwd_stats("flash_bwd_dkv", q, g, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() == 0 or Tq == 0:
        return dk.zero_(), dv.zero_()
    fn = _build.load("flash_bwd_dkv")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            dk.data_ptr(), dv.data_ptr(), B * H, H, Tq, Tk, D, float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream_ptr(q))
    if rc != 0:
        raise MXNetError(
            f"flash_bwd_dkv kernel launch failed: CUDA error {rc}")
    flash_bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale, causal):
    """Launch the dQ kernel of ``csrc/flash_bwd.cu`` (operands as
    :func:`flash_bwd_dkv_cuda`). Returns dq in q's dtype."""
    global flash_bwd_dq_launches
    B, H, Tq, Tk, D = _check_attention("flash_bwd_dq", q, k, v, q_seg,
                                       k_seg, g, lse, delta)
    _check_bwd_stats("flash_bwd_dq", q, g, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or Tk == 0:
        return dq.zero_()
    fn = _build.load("flash_bwd_dq")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *_seg_ptrs(q_seg, k_seg),
            dq.data_ptr(), B * H, H, Tq, Tk, D, float(scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype], _stream_ptr(q))
    if rc != 0:
        raise MXNetError(
            f"flash_bwd_dq kernel launch failed: CUDA error {rc}")
    flash_bwd_dq_launches += 1
    return dq


def flash_bwd_cuda(q, k, v, out, lse, g, q_seg, k_seg, scale, causal):
    """The flash-attention backward on the card: Δ = rowsum(g ∘ out) in
    fp32 (one torch reduction, outside the kernels as in the reference,
    pallas_kernels.py:647-648), then the dK/dV and dQ kernels. Operands as
    :func:`flash_fwd_cuda`, plus the forward's ``out`` and ``lse`` and the
    output gradient ``g`` (B, H, Tq, D), all contiguous. Returns
    (dq, dk, dv) in the operands' dtype. The two kernel wrappers check the
    operands."""
    if out.shape != q.shape:
        raise MXNetError(
            f"flash_bwd: out {tuple(out.shape)} must match q "
            f"{tuple(q.shape)}")
    delta = (g.float() * out.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale,
                                causal)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, q_seg, k_seg, scale,
                           causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, scale, causal):
        out, lse = flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal)
        ctx.mark_non_differentiable(lse)
        # out itself (contiguous, owned by the kernel) for Δ, never a view
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        # the caller's merge of heads hands a transposed view: the kernels
        # read rows, so make it contiguous
        dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, g_out.contiguous(),
                                    q_seg, k_seg, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, q_segment_ids=None,
                    kv_segment_ids=None, return_lse=False):
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
    """
    if kv_segment_ids is None:
        kv_segment_ids = q_segment_ids
    if q_segment_ids is None:
        q_segment_ids = kv_segment_ids
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32)
        kv_segment_ids = kv_segment_ids.to(torch.int32)
    if q.device.type == "cpu":
        out, lse = attention_plain(q, k, v, s, causal, q_segment_ids,
                                   kv_segment_ids)
    elif q.device.type == "cuda":
        if q_segment_ids is not None:
            q_segment_ids = q_segment_ids.contiguous()
            kv_segment_ids = kv_segment_ids.contiguous()
        out, lse = _FlashAttention.apply(q, k, v, q_segment_ids,
                                         kv_segment_ids, s, causal)
    else:
        raise MXNetError(
            f"flash_attention: unsupported device {q.device}")
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


def layer_norm_cuda(x, gamma, beta, eps):
    """Launch ``csrc/layer_norm.cu``: row LayerNorm over x's last axis.
    x contiguous float32/bfloat16 on CUDA; gamma/beta (d,) float32 or
    bfloat16. Returns a new tensor of x's shape and dtype."""
    global layer_norm_launches
    _check_cuda("fused_layer_norm", x, gamma, beta)
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
            _DTYPE_CODE[gamma.dtype], _stream_ptr(x))
    if rc != 0:
        raise MXNetError(
            f"layer_norm kernel launch failed: CUDA error {rc}")
    layer_norm_launches += 1
    return out


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return layer_norm_cuda(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        # the vjp of the plain formula, as the reference's _fused_ln_bwd
        # (pallas_kernels.py:958-962)
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            xs, gs, bs = (t.detach().requires_grad_() for t in
                          (x, gamma, beta))
            out = layer_norm_plain(xs, gs, bs, ctx.eps)
            gx, gg, gb = torch.autograd.grad(out, (xs, gs, bs), g)
        return gx, gg, gb, None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """Row-wise LayerNorm over the last axis (reference:
    pallas_kernels.py:883). Differentiable: the kernel runs forward, the
    backward is the plain formula's vjp."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    if x.device.type == "cuda":
        return _FusedLayerNorm.apply(x, gamma, beta, eps)
    raise MXNetError(f"fused_layer_norm: unsupported device {x.device}")
