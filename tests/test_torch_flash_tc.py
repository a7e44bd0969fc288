"""PyTorch/CUDA port: the arithmetic of the tensor-core flash-attention
forward (``mxnet_tpu_torch/csrc/flash_fwd.cu``) and of the backward's dQ
and dK/dV kernels (``mxnet_tpu_torch/csrc/flash_bwd_dq.cu``,
``flash_bwd.cu``), modelled in numpy.

The kernels cannot run on the CPU, so this file rebuilds what they compute
lane by lane: TF32 rounding as ``cvt.rna.tf32.f32`` does it, the hi/lo
split and its three products (3xTF32), the fragment layouts of
``mma.sync.m16n8k8`` TF32, one warp's 16 query rows walking the keys in
tiles of ``block_k``. The forward keeps the online softmax on the
accumulator fragments (in log2 units, as the kernel keeps them) and feeds P
V from the S fragments in the permuted key order; dQ builds S and dP as the
forward builds S, dS on the accumulator layout, and feeds dS K from the dS
fragments in the same permuted order; dK/dV builds the transposed scores
S^T and dP^T with K and V as the stationary operands and feeds P^T and
dS^T to dV and dK the same way. The models are held to the JAX package's
``_attention_reference`` (``mxnet_tpu/ops/pallas_kernels.py:138``) and
``_attention_bwd_blockwise`` (:746) at small ragged shapes.
"""
import jax.numpy as jnp
import numpy as onp
import pytest

from mxnet_tpu.ops.pallas_kernels import (_attention_bwd_blockwise,
                                          _attention_reference)

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


# -- the backward's dQ kernel -------------------------------------------------
LOG2E = onp.float32(1.4426950408889634)


def warp_dq(q, k, v, g, lse, delta, qseg, kseg, scale, causal, w0, block_k,
            n_split, ds_split=3):
    """Rows w0..w0+15 of one batch-head's dQ as ``flash_bwd_dq_kernel``
    computes them: q, g (Tq, D), k, v (Tk, D) float32, the forward's lse and
    Delta = rowsum(g o) (Tq,), segment ids (Tq,), (Tk,) or None. ``n_split``
    is the TF32 products of S and dP and of K's side of dS K (3 fp32, 1
    bf16); ``ds_split`` 3 splits ds into hi + lo (the kernel, both dtypes),
    1 rounds it once to TF32 (what the kernel must not do). Returns (rows,
    dq (len(rows), D))."""
    Tq, D = q.shape
    Tk = k.shape[0]
    kD = next(c for c in (16, 32, 64, 128) if D <= c)   # head-dim class
    nk = -(-max(Tk, 1) // block_k) * block_k
    # staged tiles: zero past D and past Tk
    kp = onp.zeros((nk, kD), onp.float32)
    vp = onp.zeros((nk, kD), onp.float32)
    kp[:Tk, :D], vp[:Tk, :D] = k, v
    qp = onp.zeros((Tq + 16, kD), onp.float32)
    gp = onp.zeros((Tq + 16, kD), onp.float32)
    qp[:Tq, :D], gp[:Tq, :D] = q, g
    r0, r1 = w0 + G, w0 + G + 8
    offset = Tk - Tq
    wend = Tk
    if causal:
        wend = min(Tk, max(min(w0 + 16, Tq) + offset, 0))
    ids = onp.zeros(nk, onp.int32)
    qs = (onp.zeros(32, onp.int32), onp.zeros(32, onp.int32))
    if qseg is not None:
        ids[:Tk] = kseg
        qs = tuple(onp.where(r < Tq, qseg[onp.minimum(r, Tq - 1)], 0)
                   for r in (r0, r1))
    lim = tuple(onp.minimum(r + offset, Tk - 1) if causal
                else onp.full(32, Tk - 1) for r in (r0, r1))
    scale2 = onp.float32(scale) * LOG2E
    # lse in log2 units and Delta of the thread's rows; 0 past Tq
    lse2 = [onp.where(r < Tq, lse[onp.minimum(r, Tq - 1)] * LOG2E,
                      onp.float32(0)).astype(onp.float32) for r in (r0, r1)]
    dl = [onp.where(r < Tq, delta[onp.minimum(r, Tq - 1)],
                    onp.float32(0)).astype(onp.float32) for r in (r0, r1)]

    # the planes: Q's and G's A fragments, split once a block
    def a_frags(xp):
        return [split(onp.stack([xp[r, ks * 8 + c] for r, c in
                                 ((r0, T4), (r1, T4), (r0, T4 + 4),
                                  (r1, T4 + 4))], 1), n_split)
                for ks in range(kD // 8)]

    qf, gf = a_frags(qp), a_frags(gp)
    acc = onp.zeros((kD // 8, 32, 4), onp.float32)
    for kb in range(0, wend, block_k):
        s = onp.zeros((block_k // 8, 32, 4), onp.float32)
        dp = onp.zeros((block_k // 8, 32, 4), onp.float32)
        for ks in range(kD // 8):
            for nt in range(block_k // 8):
                key = kb + nt * 8 + G
                for acc_t, (ah, al), xp in ((s, qf[ks], kp),
                                            (dp, gf[ks], vp)):
                    bh, bl = split(onp.stack([xp[key, ks * 8 + T4],
                                              xp[key, ks * 8 + T4 + 4]], 1),
                                   n_split)
                    acc_t[nt] = mma_split(acc_t[nt], ah, al, bh, bl,
                                          n_split)
        # dS = P (dP - Delta) on the accumulator layout; hidden scores give
        # p = 2^-inf = 0; the FFMA rounds s * scale2 - lse2 once
        for nt in range(block_k // 8):
            for e in range(4):
                h = e // 2
                j = kb + nt * 8 + 2 * T4 + (e & 1)
                ok = (j <= lim[h]) & (ids[j] == qs[h])
                x = (s[nt][:, e].astype(onp.float64) * scale2
                     - lse2[h]).astype(onp.float32)
                p = onp.exp2(onp.where(ok, x, -onp.inf))
                s[nt][:, e] = p * (dp[nt][:, e] - dl[h])
        # dQ += dS K: the dS fragment as the A operand (keys 2t -> k-slot t,
        # 2t + 1 -> k-slot t + 4), K read as the forward reads V
        for kk in range(block_k // 8):
            a = s[kk][:, [0, 2, 1, 3]]
            ah, al = split(a, 3) if ds_split == 3 else (tf32(a),
                                                       onp.zeros_like(a))
            key = kb + kk * 8 + 2 * T4
            for nd in range(kD // 8):
                bh, bl = split(onp.stack([kp[key, nd * 8 + G],
                                          kp[key + 1, nd * 8 + G]], 1),
                               n_split)
                acc[nd] = mma_split(acc[nd], ah, al, bh, bl, 3)
    out = onp.zeros((16, kD), onp.float32)
    for nd in range(kD // 8):
        for e, (r, c) in enumerate(C_RC):
            out[r, nd * 8 + c] = acc[nd][:, e] * onp.float32(scale)
    rows = onp.arange(w0, min(w0 + 16, Tq))
    return rows, out[:len(rows), :D]


def model_dq(q, k, v, g, qseg, kseg, scale, causal, block_k, n_split,
             ds_split=3):
    """(B, H, Tq, D) dQ through :func:`warp_dq`, every warp of every
    batch-head, with lse from :func:`model_forward` (the forward kernel's,
    fp32 out) and Delta = rowsum(g o) in fp32, as the wrapper computes it."""
    out, lse = model_forward(q, k, v, qseg, kseg, scale, causal, block_k,
                             n_split)
    delta = (g * out).sum(-1, dtype=onp.float32)
    B, H, Tq, D = q.shape
    dq = onp.zeros(q.shape, onp.float32)
    for b in range(B):
        for h in range(H):
            for w0 in range(0, Tq, 16):
                rows, d = warp_dq(
                    q[b, h], k[b, h], v[b, h], g[b, h], lse[b, h],
                    delta[b, h], None if qseg is None else qseg[b],
                    None if kseg is None else kseg[b], scale, causal, w0,
                    block_k, n_split, ds_split)
                dq[b, h, rows] = d
    return dq


def _reference_dq(q, k, v, g, qs, ks, scale):
    dq, _, _ = _attention_bwd_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        scale, True, jnp.asarray(qs), jnp.asarray(ks))
    return onp.asarray(dq)


# the reference sums in fp32 in another order, with its own softmax stats
# (~1e-7 each on values of O(1)); 3xTF32 drops lo * lo' and rounds lo,
# ~2^-22 of each product: the model agrees to a few 1e-7
DQ_TOL = 1e-5


@pytest.mark.parametrize("block_k", [16, 32, 64])
def test_dq_tensor_core_model_matches_reference(block_k):
    q, k, v, qs, ks = _inputs()
    g = onp.random.RandomState(4).randn(*q.shape).astype("float32")
    scale = 1 / 8
    want = _reference_dq(q, k, v, g, qs, ks, scale)
    got = model_dq(q, k, v, g, qs, ks, scale, True, block_k, 3)
    assert float(onp.abs(got - want).max()) <= DQ_TOL
    # the row that sees no key: exact zeros
    assert float(onp.abs(got[:, :, 5]).max()) == 0.0


def test_dq_bf16_needs_ds_split_into_two_products():
    # bf16 operands are exact in TF32, so S and dP take one product each;
    # ds is fp32 (the reference multiplies fp32 ds by k.astype(float32)):
    # one TF32 rounding of ds misses 1e-4 where hi + lo against K's exact
    # value (two products) holds it
    q, k, v, qs, ks = (_bf16(a) if a.dtype == onp.float32 else a
                       for a in _inputs(seed=5))
    g = _bf16(onp.random.RandomState(6).randn(*q.shape).astype("float32"))
    scale = 1 / 8
    want = _reference_dq(q, k, v, g, qs, ks, scale)
    err = {n: float(onp.abs(model_dq(q, k, v, g, qs, ks, scale, True, 32, 1,
                                     ds_split=n) - want).max())
           for n in (1, 3)}
    assert err[3] <= DQ_TOL
    assert err[1] > 1e-4          # chip_smoke.py's FLASH_TOL
    assert err[1] >= 100 * err[3]


# -- the backward's dK/dV kernel ----------------------------------------------
def warp_dkv(q, k, v, g, lse, delta, qseg, kseg, scale, causal, w0, block_q,
             block_k, n_split, p_split=3):
    """Keys w0..w0+15 of one batch-head's dK and dV as
    ``flash_bwd_dkv_kernel`` computes them: q, g (Tq, D), k, v (Tk, D)
    float32, the forward's lse and Delta = rowsum(g o) (Tq,), segment ids
    (Tq,), (Tk,) or None. The warp builds S^T = K Q^T and dP^T = V G^T with
    K and V as the stationary A operands (split once) and the staged query
    tile as B, then feeds the P^T and dS^T accumulator fragments as A
    operands of dV += P^T G and dK += dS^T Q in the permuted query order;
    fp32 (``n_split`` 3) sums each query tile from zero and adds it to
    running sums, as the kernel does in shared memory. ``n_split`` is the TF32 products of S^T and dP^T and of G's and Q's side
    of the dV and dK products (3 fp32, 1 bf16); ``p_split`` 3 splits p and
    ds into hi + lo (the kernel, both dtypes), 1 rounds them once to TF32
    (what the kernel must not do). Returns (keys, dk, dv (len(keys), D))."""
    Tq, D = q.shape
    Tk = k.shape[0]
    kD = next(c for c in (16, 32, 64, 128) if D <= c)   # head-dim class
    # staged tiles: zero past D and past Tq (a tile may start anywhere)
    qp = onp.zeros((Tq + 2 * block_q, kD), onp.float32)
    gp = onp.zeros((Tq + 2 * block_q, kD), onp.float32)
    qp[:Tq, :D], gp[:Tq, :D] = q, g
    kp = onp.zeros((Tk + 16, kD), onp.float32)
    vp = onp.zeros((Tk + 16, kD), onp.float32)
    kp[:Tk, :D], vp[:Tk, :D] = k, v
    # the tile's lse and Delta, zero past Tq, and the query ids (0 past Tq
    # and without ids)
    lse_p = onp.zeros(Tq + 2 * block_q, onp.float32)
    dl_p = onp.zeros(Tq + 2 * block_q, onp.float32)
    lse_p[:Tq], dl_p[:Tq] = lse, delta
    qid = onp.zeros(Tq + 2 * block_q, onp.int32)
    j = (w0 + G, w0 + G + 8)
    kid = (onp.zeros(32, onp.int32), onp.zeros(32, onp.int32))
    if qseg is not None:
        qid[:Tq] = qseg
        kid = tuple(onp.where(jj < Tk, kseg[onp.minimum(jj, Tk - 1)], 0)
                    for jj in j)
    offset = Tk - Tq
    k0 = w0 // block_k * block_k        # the block's first key
    qbeg = max(k0 - offset, 0) if causal else 0
    wbeg = w0 - offset if causal else 0
    # key j sees queries i with ilo <= i < ilo + span: its causal start and
    # Tq; a key past Tk sees none
    ilo = tuple(onp.maximum(jj - offset, 0) if causal
                else onp.zeros(32, onp.int64) for jj in j)
    span = tuple(onp.where(jj < Tk, onp.maximum(Tq - lo, 0), 0)
                 for jj, lo in zip(j, ilo))
    scale2 = onp.float32(scale) * LOG2E

    def a_frags(xp):
        return [split(onp.stack([xp[r, ks * 8 + c] for r, c in
                                 ((j[0], T4), (j[1], T4), (j[0], T4 + 4),
                                  (j[1], T4 + 4))], 1), n_split)
                for ks in range(kD // 8)]

    kf, vf = a_frags(kp), a_frags(vp)
    dka = onp.zeros((kD // 8, 32, 4), onp.float32)
    dva = onp.zeros((kD // 8, 32, 4), onp.float32)
    for qb in range(qbeg, Tq, block_q):
        if w0 >= Tk or qb + block_q <= wbeg:
            continue                    # no key of the warp sees the tile
        s = onp.zeros((block_q // 8, 32, 4), onp.float32)
        dp = onp.zeros((block_q // 8, 32, 4), onp.float32)
        for ks in range(kD // 8):
            for nt in range(block_q // 8):
                qrow = qb + nt * 8 + G
                for acc_t, (ah, al), xp in ((s, kf[ks], qp),
                                            (dp, vf[ks], gp)):
                    bh, bl = split(onp.stack([xp[qrow, ks * 8 + T4],
                                              xp[qrow, ks * 8 + T4 + 4]], 1),
                                   n_split)
                    acc_t[nt] = mma_split(acc_t[nt], ah, al, bh, bl,
                                          n_split)
        # P^T and dS^T on the accumulator layout (keys in rows, queries in
        # columns); hidden scores give p = 2^-inf = 0; the FFMA rounds
        # s * scale2 - lse2 once
        for nt in range(block_q // 8):
            for e in range(4):
                h = e // 2
                i = qb + nt * 8 + 2 * T4 + (e & 1)
                ok = (i >= ilo[h]) & (i - ilo[h] < span[h]) & \
                    (qid[i] == kid[h])
                l2 = (lse_p[i] * LOG2E).astype(onp.float32)
                x = (s[nt][:, e].astype(onp.float64) * scale2
                     - l2).astype(onp.float32)
                p = onp.exp2(onp.where(ok, x, -onp.inf)).astype(onp.float32)
                s[nt][:, e] = p
                dp[nt][:, e] = p * (dp[nt][:, e] - dl_p[i])
        # dV += P^T G, dK += dS^T Q: the fragment as the A operand (queries
        # 2t -> k-slot t, 2t + 1 -> k-slot t + 4), G and Q read as the
        # forward reads V; fp32 sums each tile from zero and adds it to the
        # running sums, bf16 sums in the accumulator throughout
        tile = n_split == 3
        tdv = onp.zeros_like(dva) if tile else dva
        tdk = onp.zeros_like(dka) if tile else dka
        for kk in range(block_q // 8):
            qrow = qb + kk * 8 + 2 * T4
            for acc, c, xp in ((tdv, s[kk], gp), (tdk, dp[kk], qp)):
                a = c[:, [0, 2, 1, 3]]
                ah, al = split(a, 3) if p_split == 3 else (
                    tf32(a), onp.zeros_like(a))
                for nd in range(kD // 8):
                    bh, bl = split(onp.stack([xp[qrow, nd * 8 + G],
                                              xp[qrow + 1, nd * 8 + G]], 1),
                                   n_split)
                    acc[nd] = mma_split(acc[nd], ah, al, bh, bl, 3)
        if tile:
            dva += tdv
            dka += tdk
    dk = onp.zeros((16, kD), onp.float32)
    dv = onp.zeros((16, kD), onp.float32)
    for nd in range(kD // 8):
        for e, (r, c) in enumerate(C_RC):
            dk[r, nd * 8 + c] = dka[nd][:, e] * onp.float32(scale)
            dv[r, nd * 8 + c] = dva[nd][:, e]
    keys = onp.arange(w0, min(w0 + 16, Tk))
    return keys, dk[:len(keys), :D], dv[:len(keys), :D]


def model_dkv(q, k, v, g, qseg, kseg, scale, causal, block_q, block_k,
              n_split, p_split=3):
    """(B, H, Tk, D) dK and dV through :func:`warp_dkv`, every warp of every
    batch-head, with lse from :func:`model_forward` (the forward kernel's,
    fp32 out) and Delta = rowsum(g o) in fp32, as the wrapper computes it."""
    out, lse = model_forward(q, k, v, qseg, kseg, scale, causal, 32,
                             n_split)
    delta = (g * out).sum(-1, dtype=onp.float32)
    B, H, Tk, D = k.shape
    dk = onp.zeros(k.shape, onp.float32)
    dv = onp.zeros(k.shape, onp.float32)
    for b in range(B):
        for h in range(H):
            for w0 in range(0, Tk, 16):
                keys, a, c = warp_dkv(
                    q[b, h], k[b, h], v[b, h], g[b, h], lse[b, h],
                    delta[b, h], None if qseg is None else qseg[b],
                    None if kseg is None else kseg[b], scale, causal, w0,
                    block_q, block_k, n_split, p_split)
                dk[b, h, keys], dv[b, h, keys] = a, c
    return dk, dv


def _inputs_bwd(seed, Tq, Tk, D=64, B=1, H=2):
    """q, g (B, H, Tq, D), k, v (B, H, Tk, D), padding ids from 70 % of
    each length, and query row 5 with an id no key has (it sees nothing)."""
    rng = onp.random.RandomState(seed)
    q, g = (rng.randn(B, H, Tq, D).astype("float32") for _ in range(2))
    k, v = (rng.randn(B, H, Tk, D).astype("float32") for _ in range(2))
    ks = onp.ones((B, Tk), "int32")
    ks[:, int(0.7 * Tk):] = 0
    qs = onp.ones((B, Tq), "int32")
    qs[:, int(0.7 * Tq):] = 0
    qs[:, 5] = 9
    return q, k, v, g, qs, ks


def _reference_dkv(q, k, v, g, qs, ks, scale, causal):
    _, dk, dv = _attention_bwd_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        scale, causal, jnp.asarray(qs), jnp.asarray(ks))
    return onp.asarray(dk), onp.asarray(dv)


def _exact_dkv(q, k, v, g, qs, ks, scale, causal):
    """dK and dV in float64 from the dense identities: the ground truth
    both the model and the reference round away from."""
    q, k, v, g = (a.astype("float64") for a in (q, k, v, g))
    Tq, Tk = q.shape[2], k.shape[2]
    s = onp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    vis = qs[:, None, :, None] == ks[:, None, None, :]
    if causal:
        vis = vis & onp.tril(onp.ones((Tq, Tk), bool), Tk - Tq)[None, None]
    s = onp.where(vis, s, -1e30)
    e = onp.where(vis, onp.exp(s - s.max(-1, keepdims=True)), 0.0)
    p = e / onp.maximum(e.sum(-1, keepdims=True), 1e-300)
    delta = (g * (p @ v)).sum(-1, keepdims=True)
    ds = p * (g @ onp.swapaxes(v, -1, -2) - delta) * scale
    return onp.swapaxes(ds, -1, -2) @ q, onp.swapaxes(p, -1, -2) @ g


# 1e-6 of the largest value (dK and dV reach ~2.4 here). The reference sums
# in fp32 in another order and is itself up to 1.4e-6 from the float64
# answer at these inputs, so the model is held to both, each within 1e-6
# of the largest value (3xTF32 drops lo * lo' and rounds lo, ~2^-22 of
# each product; one TF32 product would be off by ~1e-3)
DKV_RTOL = 1e-6


def _close(got, want):
    return float(onp.abs(got - want).max()) <= DKV_RTOL * max(
        1.0, float(onp.abs(want).max()))


@pytest.mark.parametrize("block_q,block_k,Tq,Tk,causal", [
    (32, 16, 100, 100, True), (32, 32, 100, 100, True),
    (32, 64, 100, 100, True), (32, 16, 70, 100, True),
    (32, 32, 70, 100, True), (32, 64, 70, 100, True),
    (16, 32, 100, 70, False), (64, 32, 100, 70, True),
])
def test_dkv_tensor_core_model_matches_reference(block_q, block_k, Tq, Tk,
                                                 causal):
    # causal bottom-right (Tk - Tq = 30 or -30), padding ids, ragged
    # lengths that no tile divides and a query row that sees no key
    q, k, v, g, qs, ks = _inputs_bwd(7, Tq, Tk)
    scale = 1 / 8
    want_dk, want_dv = _reference_dkv(q, k, v, g, qs, ks, scale, causal)
    dk, dv = model_dkv(q, k, v, g, qs, ks, scale, causal, block_q, block_k,
                       3)
    exact_dk, exact_dv = _exact_dkv(q, k, v, g, qs, ks, scale, causal)
    for got, want, exact in ((dk, want_dk, exact_dk), (dv, want_dv,
                                                       exact_dv)):
        assert _close(got, want) and _close(got, exact)


def test_dkv_key_no_query_sees_is_exact_zero():
    # causal with Tq < Tk: key j is seen by queries i >= j - (Tk - Tq), so
    # with ids that hide the only queries that could see the last keys,
    # those keys' gradients are exact zeros, as the reference's
    q, k, v, g, qs, ks = _inputs_bwd(8, 40, 60, D=32)
    ks[:, 50:] = 3          # an id no query carries
    dk, dv = model_dkv(q, k, v, g, qs, ks, 1 / 8, True, 16, 32, 3)
    assert float(onp.abs(dk[:, :, 50:]).max()) == 0.0
    assert float(onp.abs(dv[:, :, 50:]).max()) == 0.0
    want_dk, want_dv = _reference_dkv(q, k, v, g, qs, ks, 1 / 8, True)
    assert _close(dk, want_dk) and _close(dv, want_dv)


def test_dkv_bf16_needs_p_and_ds_split_into_two_products():
    # bf16 operands are exact in TF32, so S^T and dP^T take one product
    # each; p and ds are fp32 (the reference multiplies them by g and q cast
    # to float32): one TF32 rounding of them misses 1e-4 where hi + lo
    # against G's and Q's exact values (two products) holds it
    q, k, v, g, qs, ks = (_bf16(a) if a.dtype == onp.float32 else a
                          for a in _inputs_bwd(9, 100, 100))
    scale = 1 / 8
    want = _reference_dkv(q, k, v, g, qs, ks, scale, True)
    got = {n: model_dkv(q, k, v, g, qs, ks, scale, True, 32, 32, 1,
                        p_split=n) for n in (1, 3)}
    err = {n: max(float(onp.abs(a - b).max()) for a, b in zip(got[n], want))
           for n in got}
    assert all(_close(a, b) for a, b in zip(got[3], want))
    assert err[1] > 1e-4          # chip_smoke.py's FLASH_TOL
    assert err[1] >= 100 * err[3]
