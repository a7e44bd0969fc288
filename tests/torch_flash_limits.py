"""Limits for the float16 and fp8 flash-attention instances against their
plain versions, and the faults they must catch; shared by
``tests/test_torch_amp16.py`` and ``chip_smoke.py`` (no JAX at import).

Every limit is, element by element,

    |got - want| <= 2u / (1 - u) |want| + sub + 2 delta

u the format's unit roundoff and sub the spacing of its subnormals: both
sides round one value to the format, and ``delta`` bounds how far apart
the two values lie before that rounding. Its near-zero term is each
element's own, from what that element is summed from:

- forward, held to ``attention_tiled_plain`` at the kernel's block_k (the
  same p against the same running max, rounded the same way): the two fp32
  computations of a p (the kernel's ex2.approx of TF32 scores against
  torch's exp, ~3e-7 relative) can round it to neighbouring values where
  it lies that near a rounding boundary. One such flip moves out_id by at
  most 2u max_j p_ij |v_jd| + sub max_j |v_jd| / l_i (l_i the row's sum of
  exp(s - max s)); delta allows ``FLIPS[dtype]`` of them a row (expected:
  ~3e-3 a 1024-key row at fp8, ~0.5 at float16), plus 2^-12 of
  sum_j p_ij |v_jd| for the sums: the tensor cores' accumulator truncates
  at each product step (up to 2^-23 of the running sum, ~2^-16 over 1024
  keys), the plain version's sums run in another order;
- backward, held to ``attention_bwd_plain``: the kernels split p and ds
  into two TF32 parts (~2^-21 relative) and keep each sum in the
  truncating accumulator (~2^-13 over 1024 keys or queries), so delta is
  2^-12 of each gradient's sum of magnitudes: sum_i p_ij |g_i| for dv,
  sum_j |ds_ij| |k_j| for dq, sum_i |ds_ij| |q_i| for dk, where |ds_ij|
  takes 2^-8 of the magnitudes that dp_ij - Δ_i is summed from beside it
  (fp32 sums in another order, where the two cancel);
- ``normalized=True`` (``attention_plain`` against the reference's
  ``_attention_reference``, both rounding the normalized p): a flip moves
  out_id by at most 2u max_j p_ij |v_jd| + sub max_j |v_jd|.

``planted_faults`` runs a forward and a backward with the faults a wrong
kernel would make and returns how far over these limits each lands.
"""
import torch

from mxnet_tpu_torch.ops import cuda_kernels as ck

U = {"float16": 2.0 ** -11, "float8_e4m3fn": 2.0 ** -4,
     "float8_e5m2": 2.0 ** -3}
SUB = {"float16": 2.0 ** -24, "float8_e4m3fn": 2.0 ** -9,
       "float8_e5m2": 2.0 ** -16}
FLIPS = {"float16": 8, "float8_e4m3fn": 2, "float8_e5m2": 2}
ROW_CHUNK = 16     # query rows a step of the max over keys
FAULTS = ("key tile dropped", "V tiles reversed", "G tiles reversed",
          "zeros past the first tile")
# the outputs each fault must push over its limit (V does not reach dv)
FAULT_HITS = {"key tile dropped": ("out", "dq", "dk", "dv"),
              "V tiles reversed": ("out", "dq", "dk"),
              "G tiles reversed": ("dq", "dk", "dv"),
              "zeros past the first tile": ("out", "dq", "dk", "dv")}


def excess(got, want, dtype, delta):
    """max over the elements of |got - want| / (2u / (1 - u) |want| + sub
    + 2 delta) (<= 1 passes; NaN where either side is)."""
    u = U[dtype]
    w = want.detach().float()
    lim = 2 * u / (1 - u) * w.abs() + SUB[dtype] + 2 * delta
    return float(((got.detach().float() - w).abs() / lim).max())


def _scores(q, k, scale, causal, q_seg, k_seg):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    vis = ck._visible(s.shape[-2], s.shape[-1], causal, q_seg, k_seg,
                      s.device)
    if vis is None:
        vis = torch.ones_like(s, dtype=torch.bool)
    return s, vis.expand_as(s)


def _max_product(p, va):
    """max_j p_ij va_jd over (H, Tq, Tk) and (H, Tk, D), a chunk of query
    rows at a time."""
    return torch.cat([(p[:, r:r + ROW_CHUNK, :, None] * va[:, None]).amax(2)
                      for r in range(0, p.shape[1], ROW_CHUNK)], dim=1)


def forward_delta(q, k, v, scale, causal, q_seg, k_seg, dtype,
                  normalized=False):
    """delta of the forward's output, (B, H, Tq, D) float32."""
    out = []
    for b in range(q.shape[0]):
        qs, ks = (None, None) if q_seg is None else (q_seg[b:b + 1],
                                                    k_seg[b:b + 1])
        s, vis = _scores(q[b:b + 1], k[b:b + 1], scale, causal, qs, ks)
        s, vis = s[0], vis[0]
        s = torch.where(vis, s, torch.full_like(s, -torch.inf))
        m = s.amax(-1, keepdim=True).clamp_min(-1e30)
        e = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
        l = e.sum(-1, keepdim=True).clamp_min(1.0)
        p = e / l
        va = v[b].float().abs()
        vmax = va.amax(1, keepdim=True)
        sub = SUB[dtype] * vmax if normalized else SUB[dtype] * vmax / l
        flip = 2 * U[dtype] * _max_product(p, va) + sub
        out.append(FLIPS[dtype] * flip + 2.0 ** -12 * torch.matmul(p, va))
    return torch.stack(out)


def backward_delta(q, k, v, out, lse, g, q_seg, k_seg, scale, causal):
    """delta of (dq, dk, dv), each float32 in its operand's shape."""
    dq, dk, dv = [], [], []
    for b in range(q.shape[0]):
        qs, ks = (None, None) if q_seg is None else (q_seg[b:b + 1],
                                                    k_seg[b:b + 1])
        s, vis = _scores(q[b:b + 1], k[b:b + 1], scale, causal, qs, ks)
        p = torch.where(vis, torch.exp(s - lse[b:b + 1]),
                        torch.zeros_like(s))[0]
        gf, of = g[b].float(), out[b].float()
        vt = v[b].float().transpose(-1, -2)
        delta = (gf * of).sum(-1, keepdim=True)
        # |ds|, and 2^-8 of the magnitudes dp - Δ is summed from: fp32
        # sums in another order, where dp and Δ cancel
        ds = p * ((torch.matmul(gf, vt) - delta).abs() + 2.0 ** -8 * (
            torch.matmul(gf.abs(), vt.abs())
            + (gf * of).abs().sum(-1, keepdim=True))) * scale
        dq.append(torch.matmul(ds, k[b].float().abs()))
        dk.append(torch.matmul(ds.transpose(-1, -2), q[b].float().abs()))
        dv.append(torch.matmul(p.transpose(-1, -2), gf.abs()))
    return tuple(2.0 ** -12 * torch.stack(t) for t in (dq, dk, dv))


def flash_excess(q, k, v, g, out, lse, grads, q_seg, k_seg, scale, causal,
                 block_k, dtype, out_delta=None):
    """{"out", "dq", "dk", "dv": excess} of a kernel's forward (``out``)
    against ``attention_tiled_plain`` at ``block_k`` and its backward
    (``grads``, from that ``out`` and ``lse``) against
    ``attention_bwd_plain``, and "lse": the fp32 log-sum-exp's max |diff|.
    ``out_delta`` (:func:`forward_delta`, which depends on q, k and v
    alone) may be passed in where several tiles share the inputs."""
    ref, ref_lse = ck.attention_tiled_plain(q, k, v, scale, causal, q_seg,
                                            k_seg, block_k)
    if out_delta is None:
        out_delta = forward_delta(q, k, v, scale, causal, q_seg, k_seg,
                                  dtype)
    ex = {"out": excess(out, ref, dtype, out_delta)}
    ex.update(_backward_excess(q, k, v, g, out, lse, grads, q_seg, k_seg,
                               scale, causal, dtype))
    ex["lse"] = float((lse - ref_lse).abs().max())
    return ex


def _backward_excess(q, k, v, g, out, lse, grads, q_seg, k_seg, scale,
                     causal, dtype):
    want = ck.attention_bwd_plain(q, k, v, out, lse, g, q_seg, k_seg,
                                  scale, causal)
    deltas = backward_delta(q, k, v, out, lse, g, q_seg, k_seg, scale,
                            causal)
    return {n: excess(a, b, dtype, d) for n, a, b, d in
            zip(("dq", "dk", "dv"), grads, want, deltas)}


def _tiles_reversed(t, block):
    """``t`` (B, H, T, D), T a multiple of ``block``, with its row tiles of
    ``block`` in reverse order."""
    B, H, T, D = t.shape
    return t.reshape(B, H, T // block, block, D).flip(2).reshape(
        B, H, T, D).contiguous()


def planted_faults(fwd, bwd, q, k, v, g, scale, causal, block_q, block_k,
                   dtype):
    """How far over the limits of :func:`flash_excess` the faults of
    ``FAULTS`` land, at causal (B, H, T, D) operands without segment ids:
    {fault: {"out", "dq", "dk", "dv": excess}}, and the same of the sound
    outputs under "sound". ``fwd(q, k, v, q_seg,
    k_seg)`` gives (out, lse), ``bwd(q, k, v, out, lse, g, q_seg, k_seg)``
    (dq, dk, dv): the kernels, run on inputs that plant the fault
    (segment ids that hide the second key tile; V's or G's row tiles in
    reverse order), and their sound outputs zeroed past the first query
    (dq) or key (dk, dv) tile. The reference and its deltas are the sound
    inputs'."""
    out, lse = fwd(q, k, v, None, None)
    grads = bwd(q, k, v, out, lse, g, None, None)
    ref, _ = ck.attention_tiled_plain(q, k, v, scale, causal, None, None,
                                      block_k)
    out_delta = forward_delta(q, k, v, scale, causal, None, None, dtype)

    def over(o, gr):
        # the backward against the plain version from the sound out, lse
        r = {"out": excess(o, ref, dtype, out_delta)}
        r.update(_backward_excess(q, k, v, g, out, lse, gr, None, None,
                                  scale, causal, dtype))
        return r

    res = {"sound": over(out, grads)}
    B, T = q.shape[0], q.shape[2]
    qs = torch.ones((B, T), dtype=torch.int32, device=q.device)
    ks = qs.clone()
    ks[:, block_k:2 * block_k] = 0
    fo, fl = fwd(q, k, v, qs, ks)
    res["key tile dropped"] = over(fo, bwd(q, k, v, fo, fl, g, qs, ks))
    vr = _tiles_reversed(v, block_k)
    fo, fl = fwd(q, k, vr, None, None)
    res["V tiles reversed"] = over(fo, bwd(q, k, vr, fo, fl, g, None, None))
    res["G tiles reversed"] = over(out, bwd(q, k, v, out, lse,
                                            _tiles_reversed(g, block_q),
                                            None, None))
    zo = out.clone()
    zo[:, :, block_q:] = 0
    zg = [t.clone() for t in grads]
    zg[0][:, :, block_q:] = 0
    for t in zg[1:]:
        t[:, :, block_k:] = 0
    res["zeros past the first tile"] = over(zo, zg)
    return res


def faults_missed(res):
    """The (fault, output) pairs of ``FAULT_HITS`` that stayed within the
    limit (empty: every planted fault was caught)."""
    return [(f, n) for f, hits in FAULT_HITS.items() for n in hits
            if not res[f][n] > 1.0]
