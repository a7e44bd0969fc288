"""PyTorch/CUDA port: the arithmetic of the tensor-core flash-attention
forward (``mxnet_tpu_torch/csrc/flash_fwd.cu``), modelled in numpy.

The kernel cannot run on the CPU, so this file rebuilds what it computes
lane by lane: TF32 rounding as ``cvt.rna.tf32.f32`` does it, the hi/lo
split and its three products (3xTF32), the fragment layouts of
``mma.sync.m16n8k8`` TF32, one warp's 16 query rows walking the keys in
tiles of ``block_k`` with the online softmax on the accumulator fragments
(in log2 units, as the kernel keeps them), and P V fed from the S fragments
in the permuted key order. The model is held to the JAX package's
``_attention_reference`` (``mxnet_tpu/ops/pallas_kernels.py:138``) at a
small ragged shape.
"""
import jax.numpy as jnp
import numpy as onp
import pytest

from mxnet_tpu.ops.pallas_kernels import _attention_reference

# lane = 4 g + t
LANE = onp.arange(32)
G = LANE >> 2
T4 = LANE & 3
# (row, column) of each lane's fragment registers (PTX ISA, mma.m16n8k8
# TF32): A 16 x 8 row-major, B 8 x 8 column, C/D 16 x 8 fp32
A_RC = [(G, T4), (G + 8, T4), (G, T4 + 4), (G + 8, T4 + 4)]
B_RC = [(T4, G), (T4 + 4, G)]
C_RC = [(G, 2 * T4), (G, 2 * T4 + 1), (G + 8, 2 * T4), (G + 8, 2 * T4 + 1)]
_A_IDX = onp.stack([r * 8 + c for r, c in A_RC], 1)
_B_IDX = onp.stack([r * 8 + c for r, c in B_RC], 1)
_C_IDX = onp.stack([r * 8 + c for r, c in C_RC], 1)
NEG_INF = onp.float32(-1e30)


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero, on the 13 dropped bits (adding half
    of their range to the magnitude's bit pattern carries into the kept
    bits exactly when the dropped part is at least half)."""
    bits = onp.asarray(x, onp.float32).view(onp.uint32)
    return ((bits + onp.uint32(0x1000)) & onp.uint32(0xFFFFE000)) \
        .view(onp.float32)


def split(x, n_split):
    """The TF32 operands of ``split_tf32<n_split>``: (hi, lo)."""
    x = onp.asarray(x, onp.float32)
    if n_split == 1:            # bf16 values: exact in TF32, lo = 0
        return x, onp.zeros_like(x)
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(d, a, b):
    """``mma.sync.m16n8k8`` TF32 on the lane fragments: a (32, 4),
    b (32, 2), d (32, 4) -> d + A B. A product of two TF32 values is exact
    in fp32's range; the model sums in float64 and rounds once to fp32."""
    A = onp.empty(128)
    A[_A_IDX] = a
    B = onp.empty(64)
    B[_B_IDX] = b
    C = onp.empty(128)
    C[_C_IDX] = d
    D = (A.reshape(16, 8) @ B.reshape(8, 8) + C.reshape(16, 8)).astype(
        onp.float32).ravel()
    return D[_C_IDX]


def mma_split(d, ah, al, bh, bl, n_split):
    if n_split == 3:            # the small products first
        d = mma(d, al, bh)
        d = mma(d, ah, bl)
    return mma(d, ah, bh)


def quad(x, op):
    """The two shuffles of a quad: x op x[lane ^ 1], then op x[lane ^ 2]."""
    x = op(x, x[LANE ^ 1])
    return op(x, x[LANE ^ 2])


def warp_forward(q, k, v, qseg, kseg, scale, causal, w0, block_k, n_split,
                 p_round=None):
    """Rows w0..w0+15 of one batch-head as ``flash_fwd_kernel`` computes
    them: q (Tq, D), k, v (Tk, D) float32, segment ids (Tq,), (Tk,) or
    None. ``p_round`` casts p to V's dtype (bf16). Returns (rows, out
    (len(rows), D), lse)."""
    Tq, D = q.shape
    Tk = k.shape[0]
    kD = next(c for c in (16, 32, 64, 128) if D <= c)   # head-dim class
    nk = -(-max(Tk, 1) // block_k) * block_k
    # staged tiles: zero past D and past Tk
    kp = onp.zeros((nk, kD), onp.float32)
    vp = onp.zeros((nk, kD), onp.float32)
    kp[:Tk, :D], vp[:Tk, :D] = k, v
    qp = onp.zeros((Tq + 16, kD), onp.float32)
    qp[:Tq, :D] = q
    r0, r1 = w0 + G, w0 + G + 8
    offset = Tk - Tq
    wend = Tk
    if causal:
        wend = min(Tk, max(min(w0 + 16, Tq) + offset, 0))
    # without ids every key and row carries id 0
    ids = onp.zeros(nk, onp.int32)
    qs = (onp.zeros(32, onp.int32), onp.zeros(32, onp.int32))
    if qseg is not None:
        ids[:Tk] = kseg
        qs = tuple(onp.where(r < Tq, qseg[onp.minimum(r, Tq - 1)], 0)
                   for r in (r0, r1))
    # the last key each row may see: the ragged edge and the causal limit
    lim = tuple(onp.minimum(r + offset, Tk - 1) if causal
                else onp.full(32, Tk - 1) for r in (r0, r1))
    scale2 = onp.float32(scale) * onp.float32(1.4426950408889634)

    qf = [split(onp.stack([qp[r, ks * 8 + c] for r, c in
                           ((r0, T4), (r1, T4), (r0, T4 + 4),
                            (r1, T4 + 4))], 1), n_split)
          for ks in range(kD // 8)]
    o = onp.zeros((kD // 8, 32, 4), onp.float32)
    m = [onp.full(32, NEG_INF), onp.full(32, NEG_INF)]
    l = [onp.zeros(32, onp.float32), onp.zeros(32, onp.float32)]
    for kb in range(0, wend, block_k):
        s = onp.zeros((block_k // 8, 32, 4), onp.float32)
        for ks in range(kD // 8):
            ah, al = qf[ks]
            for nt in range(block_k // 8):
                key = kb + nt * 8 + G
                bh, bl = split(onp.stack([kp[key, ks * 8 + T4],
                                          kp[key, ks * 8 + T4 + 4]], 1),
                               n_split)
                s[nt] = mma_split(s[nt], ah, al, bh, bl, n_split)
        # scores in log2 units; hidden ones -inf
        for nt in range(block_k // 8):
            for e in range(4):
                j = kb + nt * 8 + 2 * T4 + (e & 1)
                ok = (j <= lim[e // 2]) & (ids[j] == qs[e // 2])
                s[nt][:, e] = onp.where(ok, s[nt][:, e] * scale2, -onp.inf)
        mx = [quad(onp.maximum(m[h], s[:, :, 2 * h:2 * h + 2].max((0, 2))),
                   onp.maximum) for h in (0, 1)]
        alpha = [onp.exp2(m[h] - mx[h]) for h in (0, 1)]
        m = mx
        l = [l[h] * alpha[h] for h in (0, 1)]
        o *= onp.stack([alpha[0], alpha[0], alpha[1], alpha[1]], 1)
        for kk in range(block_k // 8):
            p = onp.exp2(s[kk] - onp.stack([m[0], m[0], m[1], m[1]], 1))
            l = [l[0] + (p[:, 0] + p[:, 1]), l[1] + (p[:, 2] + p[:, 3])]
            pv = p if p_round is None else p_round(p)
            # the S fragment as the A operand: keys 2t -> k-slot t,
            # 2t + 1 -> k-slot t + 4
            ph, pl = split(pv[:, [0, 2, 1, 3]], n_split)
            key = kb + kk * 8 + 2 * T4
            for nd in range(kD // 8):
                bh, bl = split(onp.stack([vp[key, nd * 8 + G],
                                          vp[key + 1, nd * 8 + G]], 1),
                               n_split)
                o[nd] = mma_split(o[nd], ph, pl, bh, bl, n_split)
    l = [quad(l[h], onp.add) for h in (0, 1)]
    den = [onp.maximum(l[h], onp.float32(1e-30)) for h in (0, 1)]
    out = onp.zeros((16, kD), onp.float32)
    lse = onp.zeros(16, onp.float32)
    for nd in range(kD // 8):
        for e, (r, c) in enumerate(C_RC):
            out[r, nd * 8 + c] = o[nd][:, e] / den[e // 2]
    # back to natural log; a row that saw no key: -1e30 + log(1e-30),
    # which is -1e30 in fp32
    for h, rows in ((0, G), (1, G + 8)):
        lse[rows] = onp.where(
            l[h] > 0, onp.float32(0.6931471805599453)
            * (m[h] + onp.log2(onp.maximum(l[h], onp.float32(1e-30)))),
            NEG_INF)
    rows = onp.arange(w0, min(w0 + 16, Tq))
    return rows, out[:len(rows), :D], lse[:len(rows)]


def model_forward(q, k, v, qseg, kseg, scale, causal, block_k, n_split,
                  p_round=None):
    """(B, H, Tq, D) attention through :func:`warp_forward`, every warp of
    every batch-head; returns (out, lse (B, H, Tq))."""
    B, H, Tq, D = q.shape
    out = onp.zeros(q.shape, onp.float32)
    lse = onp.zeros((B, H, Tq), onp.float32)
    for b in range(B):
        for h in range(H):
            for w0 in range(0, Tq, 16):
                rows, o, ls = warp_forward(
                    q[b, h], k[b, h], v[b, h],
                    None if qseg is None else qseg[b],
                    None if kseg is None else kseg[b], scale, causal, w0,
                    block_k, n_split, p_round)
                out[b, h, rows], lse[b, h, rows] = o, ls
    return out, lse


def _inputs(seed=0, B=1, H=2, T=100, D=64):
    """Ragged T = 100, padding ids from key 70 and query row 5 with an id
    no key has (it sees nothing)."""
    rng = onp.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, T, D).astype("float32") for _ in range(3))
    ks = onp.ones((B, T), "int32")
    ks[:, 70:] = 0
    qs = ks.copy()
    qs[:, 5] = 9
    return q, k, v, qs, ks


def _reference(q, k, v, qs, ks, scale):
    out = onp.asarray(_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True,
        jnp.asarray(qs), jnp.asarray(ks)))
    # the reference's LSE, in float64: m + log(max(l, 1e-30)) over the
    # visible scores
    s = onp.einsum("bhqd,bhkd->bhqk", q.astype("float64"),
                   k.astype("float64")) * scale
    T = q.shape[2]
    vis = onp.tril(onp.ones((T, T), bool))[None, None] & \
        (qs[:, None, :, None] == ks[:, None, None, :])
    s = onp.where(vis, s, -1e30)
    mx = s.max(-1, keepdims=True)
    e = onp.where(vis, onp.exp(s - mx), 0.0)
    lse = (mx + onp.log(onp.maximum(e.sum(-1, keepdims=True), 1e-30)))[..., 0]
    return out, lse


# fp32 sums of up to 100 terms in another order (~6e-8 each) plus
# 3xTF32's dropped lo * lo' term and the rounding of lo, ~2^-22 of each
# product: outputs and LSEs of O(1) agree to a few 1e-7 (4.8e-7 and
# 4.3e-7 at these inputs); one TF32 product would be off by ~1e-3
MODEL_TOL = 1e-6


@pytest.mark.parametrize("block_k", [16, 32, 64])
def test_tensor_core_model_matches_reference(block_k):
    q, k, v, qs, ks = _inputs()
    scale = 1 / 8
    want, want_lse = _reference(q, k, v, qs, ks, scale)
    out, lse = model_forward(q, k, v, qs, ks, scale, True, block_k, 3)
    assert float(onp.abs(out - want).max()) <= MODEL_TOL
    seen = onp.ones(q.shape[2], bool)
    seen[5] = False
    assert float(onp.abs(lse[..., seen] - want_lse[..., seen]).max()) \
        <= MODEL_TOL
    # the row that sees no key: exact zeros and the kernel's -1e30 LSE
    assert float(onp.abs(out[:, :, 5]).max()) == 0.0
    assert (lse[:, :, 5] == NEG_INF).all()


def test_one_tf32_product_would_break_fp32_accuracy():
    # why the kernel splits fp32 operands: one TF32 product keeps ~11 bits
    q, k, v, qs, ks = _inputs()
    want, _ = _reference(q, k, v, qs, ks, 1 / 8)
    err = {}
    for n in (1, 3):
        if n == 1:   # fp32 operands rounded once, as the hardware would
            q1, k1, v1 = (tf32(a) for a in (q, k, v))
            out, _ = model_forward(q1, k1, v1, qs, ks, 1 / 8, True, 32, 1,
                                   p_round=tf32)
        else:
            out, _ = model_forward(q, k, v, qs, ks, 1 / 8, True, 32, 3)
        err[n] = float(onp.abs(out - want).max())
    assert err[1] >= 100 * err[3]
    assert err[1] > 1e-4          # chip_smoke.py's FLASH_TOL


def _bf16(x):
    """float32 rounded to bfloat16 (nearest, ties to even), as float32."""
    b = onp.asarray(x, onp.float32).view(onp.uint32)
    b = b + onp.uint32(0x7FFF) + ((b >> 16) & onp.uint32(1))
    return (b & onp.uint32(0xFFFF0000)).view(onp.float32)


def test_bf16_values_split_to_zero_lo():
    x = _bf16(onp.random.RandomState(1).randn(4096).astype("float32") * 30)
    hi, lo = split(x, 3)
    assert (hi == x).all() and (lo == 0).all()
    assert (tf32(x) == x).all()


def test_bf16_one_product_equals_three():
    # bf16 costs nothing extra: with lo = 0 the two small products add
    # exact zeros, so kSplit = 1 reproduces kSplit = 3 bit for bit
    q, k, v, qs, ks = (_bf16(a) if a.dtype == onp.float32 else a
                       for a in _inputs(seed=2, T=40, D=32))
    one = model_forward(q, k, v, qs, ks, 32 ** -0.5, True, 16, 1,
                        p_round=_bf16)
    three = model_forward(q, k, v, qs, ks, 32 ** -0.5, True, 16, 3,
                          p_round=_bf16)
    for a, b in zip(one, three):
        assert onp.array_equal(a, b)


def test_tf32_rounding_is_nearest_ties_away():
    ulp = 2.0 ** -10
    cases = {1 + ulp / 2: 1 + ulp,               # a tie: away from zero
             -(1 + ulp / 2): -(1 + ulp),
             1 + ulp / 2 - 2.0 ** -23: 1.0,      # just below the tie
             1 + 1.5 * ulp: 1 + 2 * ulp,         # a tie above an odd value
             3.0 * 2 ** -130: 3.0 * 2 ** -130}   # subnormal, exact
    for x, want in cases.items():
        assert float(tf32(onp.float32(x))) == want
    x = onp.random.RandomState(3).randn(10000).astype("float32")
    r = tf32(x)
    assert ((r.view(onp.uint32) & 0x1FFF) == 0).all()
    assert (onp.abs(r - x) <= 2.0 ** -11 * onp.abs(x)).all()
    hi, lo = split(x, 3)
    assert (onp.abs(hi.astype("float64") + lo - x)
            <= 2.0 ** -22 * onp.abs(x)).all()


def test_pv_key_permutation_pairs_each_key_once():
    # the A operand of P V is the S accumulator as it lies: per lane, the
    # key behind each A register and behind each B register at the same
    # k-slot must agree, and a row must see each of the 8 keys once
    key_of_c = [2 * T4, 2 * T4 + 1, 2 * T4, 2 * T4 + 1]     # S column
    a_from_c = [0, 2, 1, 3]            # a_i = c_{a_from_c[i]}
    key_of_b = [2 * T4, 2 * T4 + 1]    # V rows read for b0, b1
    A_key = onp.full((16, 8), -1)
    for i, (r, c) in enumerate(A_RC):
        A_key[r, c] = key_of_c[a_from_c[i]]
        assert (C_RC[a_from_c[i]][0] == r).all()           # same row
    B_key = onp.full(8, -1)
    for i, (r, _) in enumerate(B_RC):
        B_key[r] = key_of_b[i]
    assert (A_key == B_key[None, :]).all()
    assert sorted(B_key) == list(range(8))
