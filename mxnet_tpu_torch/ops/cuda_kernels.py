"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py`` for the two TPU kernels
the serving path runs:

- :func:`flash_attention` — the flash-attention forward
  (``csrc/flash_fwd.cu``, replacing ``_flash_fwd_kernel``, :163);
- :func:`fused_layer_norm` — row-wise LayerNorm (``csrc/layer_norm.cu``,
  replacing ``_ln_kernel``, :866).

Each wrapper takes its plain version (:func:`attention_plain`,
:func:`layer_norm_plain`, ports of ``_attention_reference`` and
``_ln_reference``) only for tensors that lie on the CPU. For CUDA tensors it
launches its kernel or raises: nothing falls back from a failed build or
launch. Each launch adds one to the kernel's counter
(``flash_fwd_launches``, ``layer_norm_launches``), so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "fused_layer_norm", "attention_plain",
           "layer_norm_plain", "flash_fwd_cuda", "layer_norm_cuda",
           "launch_counts", "reset_launch_counts"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128

# launches of each kernel since the last reset (plain ints; the wrappers
# below are their only writers)
flash_fwd_launches = 0
layer_norm_launches = 0


def launch_counts():
    return {"flash_fwd": flash_fwd_launches,
            "layer_norm": layer_norm_launches}


def reset_launch_counts():
    global flash_fwd_launches, layer_norm_launches
    flash_fwd_launches = 0
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
# flash attention forward
# ---------------------------------------------------------------------------
def attention_plain(q, k, v, scale, causal, q_seg=None, k_seg=None):
    """Plain version of the flash-attention forward: the reference's
    ``_attention_reference`` (pallas_kernels.py:138-157) over (B, H, T, D)
    operands, plus the fp32 log-sum-exp (B, H, Tq, 1) the kernel returns.
    A fully masked query row yields zeros."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    tq, tk = s.shape[-2], s.shape[-1]
    masked = None
    if causal:
        masked = torch.ones((tq, tk), dtype=torch.bool,
                            device=s.device).tril(tk - tq)[None, None]
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        masked = seg if masked is None else (masked & seg)
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


def flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal):
    """Launch ``csrc/flash_fwd.cu`` on contiguous (B, H, T, D) CUDA operands
    (float32 or bfloat16, D <= 128) with optional int32 (B, T) segment ids.
    Returns (out (B, H, Tq, D) in q's dtype, lse (B, H, Tq, 1) float32)."""
    global flash_fwd_launches
    ops = [q, k, v] + ([q_seg, k_seg] if q_seg is not None else [])
    _check_cuda("flash_attention", *ops)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k, v must be (B, H, T, D)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise MXNetError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not agree")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError(
            f"flash_attention: operands must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D > _MAX_HEAD_DIM or B * H > 65535:
        raise MXNetError(
            f"flash_attention: head dim {D} > {_MAX_HEAD_DIM} or B*H "
            f"{B * H} > 65535 is not supported by the kernel")
    if q_seg is not None and (
            q_seg.dtype != torch.int32 or k_seg.dtype != torch.int32
            or tuple(q_seg.shape) != (B, Tq) or tuple(k_seg.shape) != (B, Tk)):
        raise MXNetError(
            "flash_attention: segment ids must be int32 (B, Tq) / (B, Tk)")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _build.load("flash_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_seg.data_ptr() if q_seg is not None else None,
            k_seg.data_ptr() if k_seg is not None else None,
            out.data_ptr(), lse.data_ptr(), B * H, H, Tq, Tk, D,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
            _stream_ptr(q))
    if rc != 0:
        raise MXNetError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd_launches += 1
    return out, lse


class _FlashAttentionFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, scale, causal):
        out, lse = flash_fwd_cuda(q, k, v, q_seg, k_seg, scale, causal)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "flash_attention backward on CUDA: the backward kernels "
            "(_flash_bwd_dkv_kernel / _flash_bwd_dq_kernel) come with the "
            "training slice of the port")


def flash_attention(q, k, v, scale=None, causal=False, q_segment_ids=None,
                    kv_segment_ids=None, return_lse=False):
    """Fused attention over (B, H, T, D) operands (reference:
    pallas_kernels.py:310).

    ``q_segment_ids``/``kv_segment_ids`` are optional (B, T) int arrays:
    tokens attend only within equal ids; one side given alone is used for
    both. Causal masking is bottom-right aligned (query i sees keys
    <= i + Tk - Tq). Any Tq, Tk: the kernel masks the ragged edge itself.
    ``return_lse`` also returns the fp32 log-sum-exp (B, H, Tq, 1).
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
        out, lse = _FlashAttentionFwd.apply(q, k, v, q_segment_ids,
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
