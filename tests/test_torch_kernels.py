"""PyTorch/CUDA port: the kernel modules and the attention op against the
JAX package.

The same numpy inputs (from ``RandomState(seed)``) go through the JAX
function and the port's. On the CPU the port's wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode at tiling
shapes (as tests/test_attention_models.py does) and its reference path
for ragged shapes. fp32 tolerance: max |diff| <= 1e-5 (the two packages
sum in different orders; nothing else differs).

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card; they skip without one.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as tk
from mxnet_tpu_torch.ops import nn as tnn

TOL = 1e-5


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _qkv(rng, B, H, Tq, Tk, D):
    return (rng.randn(B, H, Tq, D).astype("float32"),
            rng.randn(B, H, Tk, D).astype("float32"),
            rng.randn(B, H, Tk, D).astype("float32"))


# -- flash-attention forward: the Pallas kernel in interpret mode ------------
@pytest.mark.parametrize("B,H,Tq,Tk,causal,seg", [
    (1, 2, 256, 256, False, None),
    (1, 2, 256, 256, True, None),
    (1, 2, 128, 256, False, None),     # Tq != Tk, both tiles
    (2, 2, 256, 256, True, "pad"),     # causal + right-padded tail
    (2, 1, 128, 128, False, "empty"),  # batch row 1: every key masked
])
def test_flash_fwd_matches_pallas_kernel(monkeypatch, B, H, Tq, Tk, causal,
                                         seg):
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops import pallas_kernels as pk

    D = 64
    rng = onp.random.RandomState(3)
    q, k, v = _qkv(rng, B, H, Tq, Tk, D)
    qs = ks = None
    if seg == "pad":
        qs = onp.ones((B, Tq), "int32")
        qs[1, 200:] = 0
        ks = qs.copy()
    elif seg == "empty":
        qs = onp.ones((B, Tq), "int32")
        ks = onp.ones((B, Tk), "int32")
        ks[1] = 0
    scale = 1.0 / D ** 0.5
    want, want_lse = pk._flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        min(Tq, 256), min(Tk, 512), return_lse=True,
        q_seg=None if qs is None else jnp.asarray(qs),
        k_seg=None if ks is None else jnp.asarray(ks))
    got, lse = tk.flash_attention(
        _t(q), _t(k), _t(v), None, causal,
        q_segment_ids=None if qs is None else _t(qs),
        kv_segment_ids=None if ks is None else _t(ks), return_lse=True)
    assert float(onp.abs(got.numpy() - onp.asarray(want)).max()) <= TOL
    assert float(onp.abs(lse.numpy() - onp.asarray(want_lse)).max()) <= TOL
    if seg == "empty":
        assert float(got[1].abs().max()) == 0.0


# -- flash-attention forward: ragged shapes, the JAX reference path ----------
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,seg", [
    (1, 2, 384, 384, 64, True, None),      # BERT-length, causal
    (1, 1, 300, 700, 16, False, None),     # ragged cross lengths
    (1, 2, 384, 384, 64, False, "pad"),    # ragged + padding ids
    (1, 1, 256, 256, 64, True, "left"),    # causal + left padding
    (2, 1, 100, 100, 32, False, "empty"),  # a fully masked batch row
    (1, 1, 300, 300, 16, False, "neg"),    # negative user ids
])
def test_flash_attention_matches_reference_ragged(B, H, Tq, Tk, D, causal,
                                                  seg):
    import jax.numpy as jnp

    from mxnet_tpu.ops import pallas_kernels as pk

    rng = onp.random.RandomState(29)
    q, k, v = _qkv(rng, B, H, Tq, Tk, D)
    s = None
    if seg == "pad":
        s = onp.ones((B, Tk), "int32")
        s[:, 350:] = 0
    elif seg == "left":
        s = onp.zeros((B, Tk), "int32")
        s[:, 100:] = 1
    elif seg == "empty":
        s = onp.ones((B, Tk), "int32")
        s[1] = 0
    elif seg == "neg":
        s = onp.full((B, Tk), -1, "int32")
        s[:, 150:] = -2
    qs = s
    if seg == "empty":
        qs = onp.full((B, Tq), 1, "int32")
        qs[1] = 5   # no key shares id 5: the row sees nothing
    js = None if s is None else jnp.asarray(s)
    jqs = None if qs is None else jnp.asarray(qs)
    want = pk._attention_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 1.0 / D ** 0.5, causal,
                                   jqs, js)
    got = tk.flash_attention(_t(q), _t(k), _t(v), None, causal,
                             q_segment_ids=None if qs is None else _t(qs),
                             kv_segment_ids=None if s is None else _t(s))
    assert float(onp.abs(got.numpy() - onp.asarray(want)).max()) <= TOL
    if seg == "empty":
        assert float(got[1].abs().max()) == 0.0


# -- flash-attention backward: the Pallas kernels in interpret mode ---------
def _seg_ids(kind, B, Tq, Tk):
    if kind == "pad":
        qs = onp.ones((B, Tq), "int32")
        qs[1, 200:] = 0
        return qs, qs.copy()
    if kind == "empty":
        qs = onp.ones((B, Tq), "int32")
        ks = onp.ones((B, Tk), "int32")
        ks[1] = 0
        return qs, ks
    return None, None


def _port_bwd(q, k, v, g, causal, qs, ks):
    """(plain backward, CPU autograd of the wrapper) of the port, each
    (dq, dk, dv) as numpy."""
    D = q.shape[-1]
    tq, tk_, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tqs = None if qs is None else _t(qs)
    tks = None if ks is None else _t(ks)
    out, lse = tk.flash_attention(tq, tk_, tv, None, causal, tqs, tks,
                                  return_lse=True)
    auto = torch.autograd.grad(out, (tq, tk_, tv), _t(g))
    plain = tk.attention_bwd_plain(_t(q), _t(k), _t(v), out.detach(),
                                   lse.detach(), _t(g), tqs, tks,
                                   1.0 / D ** 0.5, causal)
    return ([a.numpy() for a in plain], [a.numpy() for a in auto])


@pytest.mark.parametrize("B,H,Tq,Tk,causal,seg", [
    (1, 2, 256, 256, False, None),
    (1, 2, 256, 256, True, None),
    (1, 2, 128, 256, False, None),     # Tq != Tk, both tiles
    (1, 2, 128, 256, True, None),      # Tq != Tk causal: offset Tk - Tq
    (2, 2, 256, 256, True, "pad"),     # causal + right-padded tail
    (2, 1, 128, 128, False, "empty"),  # batch row 1: every key masked
])
def test_flash_bwd_matches_pallas_kernel(monkeypatch, B, H, Tq, Tk, causal,
                                         seg):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops import pallas_kernels as pk

    D = 64
    rng = onp.random.RandomState(13)
    q, k, v = _qkv(rng, B, H, Tq, Tk, D)
    g = rng.randn(B, H, Tq, D).astype("float32")
    qs, ks = _seg_ids(seg, B, Tq, Tk)
    jqs = None if qs is None else jnp.asarray(qs)
    jks = None if ks is None else jnp.asarray(ks)
    _, vjp = jax.vjp(lambda a, b, c: pk.flash_attention(
        a, b, c, causal=causal, q_segment_ids=jqs, kv_segment_ids=jks),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [onp.asarray(a) for a in vjp(jnp.asarray(g))]
    plain, auto = _port_bwd(q, k, v, g, causal, qs, ks)
    for got in (plain, auto):
        for a, b in zip(got, want):
            assert float(onp.abs(a - b).max()) <= TOL
    if seg == "empty":   # the masked row passes no gradient anywhere
        assert float(onp.abs(plain[0][1]).max()) == 0.0
        assert float(onp.abs(plain[1][1]).max()) == 0.0


# -- flash-attention backward: ragged shapes, the JAX blockwise backward -----
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,seg", [
    (1, 2, 384, 384, 64, True, None),      # BERT-length, causal
    (1, 2, 384, 384, 64, False, "pad"),    # ragged + padding ids
    (1, 1, 300, 700, 16, False, None),     # ragged cross lengths
    (1, 1, 300, 700, 16, True, None),      # ... causal, offset 400
    (2, 1, 100, 100, 32, True, "empty"),   # a fully masked batch row
])
def test_flash_bwd_matches_blockwise_ragged(B, H, Tq, Tk, D, causal, seg):
    import jax.numpy as jnp

    from mxnet_tpu.ops import pallas_kernels as pk

    rng = onp.random.RandomState(31)
    q, k, v = _qkv(rng, B, H, Tq, Tk, D)
    g = rng.randn(B, H, Tq, D).astype("float32")
    qs = ks = None
    if seg == "pad":
        qs = onp.ones((B, Tq), "int32")
        qs[:, 350:] = 0
        ks = qs.copy()
    elif seg == "empty":
        qs = onp.ones((B, Tq), "int32")
        qs[1] = 5   # no key shares id 5: the row sees nothing
        ks = onp.ones((B, Tk), "int32")
    want = pk._attention_bwd_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        1.0 / D ** 0.5, causal,
        q_seg=None if qs is None else jnp.asarray(qs),
        k_seg=None if ks is None else jnp.asarray(ks))
    plain, auto = _port_bwd(q, k, v, g, causal, qs, ks)
    for got in (plain, auto):
        for a, b in zip(got, want):
            assert float(onp.abs(a - onp.asarray(b)).max()) <= TOL


def test_flash_attention_one_id_side_copies_the_other():
    rng = onp.random.RandomState(1)
    q, k, v = _qkv(rng, 1, 1, 16, 16, 8)
    seg = onp.ones((1, 16), "int32")
    seg[:, 10:] = 2
    both = tk.flash_attention(_t(q), _t(k), _t(v), q_segment_ids=_t(seg),
                              kv_segment_ids=_t(seg))
    one = tk.flash_attention(_t(q), _t(k), _t(v), kv_segment_ids=_t(seg))
    assert torch.equal(both, one)


# -- fused LayerNorm ----------------------------------------------------------
@pytest.mark.parametrize("shape", [(200, 256), (4, 50, 256)])
def test_fused_layer_norm_matches_pallas_kernel(monkeypatch, shape):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas_kernels import fused_layer_norm

    rng = onp.random.RandomState(5)
    x = (rng.randn(*shape) * 3 + 1).astype("float32")
    g = rng.randn(shape[-1]).astype("float32")
    b = rng.randn(shape[-1]).astype("float32")
    gy = rng.randn(*shape).astype("float32")
    want, vjp = jax.vjp(lambda x_, g_, b_: fused_layer_norm(x_, g_, b_),
                        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, g, b))
    got = tk.fused_layer_norm(xt, gt, bt)
    assert float(onp.abs(got.detach().numpy() - onp.asarray(want)).max()) \
        <= TOL
    grads = torch.autograd.grad(got, (xt, gt, bt), _t(gy))
    for a, bb in zip(grads, vjp(jnp.asarray(gy))):
        # gamma/beta grads sum 200 rows: scale the tolerance by the sum
        tol = TOL * max(1.0, float(onp.abs(onp.asarray(bb)).max()))
        assert float(onp.abs(a.numpy() - onp.asarray(bb)).max()) <= tol


# -- the multihead_attention op: three branches + GQA -------------------------
def _mha_both(q, k, v, mask, **attrs):
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.ops import apply_op

    ins = [NDArray(q), NDArray(k), NDArray(v)]
    if mask is not None:
        ins.append(NDArray(mask))
    want = apply_op("multihead_attention", *ins, **attrs).asnumpy()
    got = tnn.multihead_attention(
        _t(q), _t(k), _t(v), mask=None if mask is None else _t(mask),
        **attrs).numpy()
    return got, want


@pytest.mark.parametrize("branch", ["flash", "segments", "dense",
                                    "dense_empty_row", "gqa"])
def test_multihead_attention_branches_match_reference(branch):
    rng = onp.random.RandomState(17)
    B, T, Hn, D = 2, 12, 4, 8
    E = Hn * D
    attrs = {"num_heads": Hn, "causal": branch in ("flash", "segments")}
    q = rng.randn(B, T, E).astype("float32")
    kv_heads = 2 if branch == "gqa" else Hn
    Tk = 20 if branch.startswith("dense") else T
    k = rng.randn(B, Tk, kv_heads * D).astype("float32")
    v = rng.randn(B, Tk, kv_heads * D).astype("float32")
    mask = None
    if branch == "segments":
        mask = onp.ones((B, 1, 1, T), "float32")
        mask[0, :, :, 7:] = 0
    elif branch.startswith("dense"):
        mask = (rng.rand(B, 1, T, Tk) > 0.3).astype("float32")
        if branch == "dense_empty_row":
            mask[1, 0, 3] = 0   # ~uniform softmax here, not zeros
    elif branch == "gqa":
        attrs["num_kv_heads"] = 2
    got, want = _mha_both(q, k, v, mask, **attrs)
    assert float(onp.abs(got - want).max()) <= TOL
    if branch == "dense_empty_row":
        assert float(onp.abs(got[1, 3]).max()) > 0.0


def test_flash_attention_op_ranks():
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.ops import apply_op

    rng = onp.random.RandomState(2)
    q, k, v = (rng.randn(3, 10, 8).astype("float32") for _ in range(3))
    seg = onp.ones((3, 10), "int32")
    seg[:, 6:] = 0
    want = apply_op("flash_attention", NDArray(q), NDArray(k), NDArray(v),
                    NDArray(seg), causal=True).asnumpy()
    got = tnn.flash_attention(_t(q), _t(k), _t(v), _t(seg), causal=True)
    assert float(onp.abs(got.numpy() - want).max()) <= TOL
    with pytest.raises(MXNetError, match="rank 2-4"):
        tnn.flash_attention(_t(q[None, None]), _t(k[None, None]),
                            _t(v[None, None]))


# -- the other functional ops the GPT path calls ------------------------------
def _op(name, *arrays, **attrs):
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.ops import apply_op

    return apply_op(name, *[NDArray(a) for a in arrays], **attrs).asnumpy()


@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "gelu",
                                 "gelu_tanh", "prelu"])
def test_leaky_relu_variants_match_reference(act):
    rng = onp.random.RandomState(4)
    x = (rng.randn(6, 10) * 2).astype("float32")
    if act == "prelu":
        alpha = onp.float32(0.3) * onp.ones(10, "float32")
        want = _op("leaky_relu", x, alpha, act_type=act)
        got = tnn.leaky_relu(_t(x), _t(alpha), act_type=act)
    else:
        want = _op("leaky_relu", x, act_type=act, slope=0.2)
        got = tnn.leaky_relu(_t(x), act_type=act, slope=0.2)
    assert float(onp.abs(got.numpy() - want).max()) <= TOL


def test_softmax_layer_norm_axis_and_dropout_match_reference():
    rng = onp.random.RandomState(6)
    x = rng.randn(3, 7).astype("float32")
    length = onp.array([7, 4, 1], "int32")
    want = _op("softmax", x, length, axis=-1, use_length=True)
    got = tnn.softmax(_t(x), axis=-1, length=_t(length))
    assert float(onp.abs(got.numpy() - want).max()) <= TOL
    want = _op("softmax", x, axis=0, temperature=2.0)
    got = tnn.softmax(_t(x), axis=0, temperature=2.0)
    assert float(onp.abs(got.numpy() - want).max()) <= TOL
    y = (rng.randn(2, 5, 4) * 3).astype("float32")
    g, b = rng.randn(5).astype("float32"), rng.randn(5).astype("float32")
    want = _op("layer_norm", y, g, b, axis=1, eps=1e-5)
    got = tnn.layer_norm(_t(y), _t(g), _t(b), axis=1)
    assert float(onp.abs(got.numpy() - want).max()) <= TOL
    # dropout: the identity outside training; inverted scaling inside
    z = torch.ones(1000)
    assert tnn.dropout(z, 0.5) is z
    gen = torch.Generator().manual_seed(0)
    d = tnn.dropout(z, 0.25, training=True, generator=gen)
    kept = d[d > 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0) / 0.75)
    assert 0.6 < float((d > 0).float().mean()) < 0.9


# -- no fallback: the CUDA wrappers refuse host tensors -----------------------
def test_cuda_wrappers_never_fall_back_to_the_host():
    x = torch.randn(4, 8)
    g, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(MXNetError, match="CUDA device"):
        tk.layer_norm_cuda(x, g, b, 1e-5)
    q = torch.randn(1, 1, 4, 8)
    with pytest.raises(MXNetError, match="CUDA device"):
        tk.flash_fwd_cuda(q, q, q, None, None, 1.0, False)
    lse = torch.zeros(1, 1, 4, 1)
    with pytest.raises(MXNetError, match="CUDA device"):
        tk.flash_bwd_cuda(q, q, q, q, lse, q, None, None, 1.0, True)
    for fn in (tk.flash_bwd_dkv_cuda, tk.flash_bwd_dq_cuda):
        with pytest.raises(MXNetError, match="CUDA device"):
            fn(q, q, q, q, lse, lse, None, None, 1.0, True)
    before = tk.launch_counts()
    tk.fused_layer_norm(x, g, b)
    qg = q.clone().requires_grad_()
    tk.flash_attention(qg, qg, qg, causal=True).sum().backward()
    assert qg.grad is not None
    assert tk.launch_counts() == before   # the plain versions count nothing


# -- on the card: each kernel against its plain version -----------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Tq,Tk,causal,seg", [
    (128, 128, True, True), (100, 333, False, False), (1000, 1000, True, True),
])
def test_flash_fwd_kernel_matches_plain_on_card(cuda, dtype, tol, Tq, Tk,
                                                causal, seg):
    rng = onp.random.RandomState(7)
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(rng, 2, 3, Tq, Tk, 64))
    qs = ks = None
    if seg:
        ks = onp.ones((2, Tk), "int32")
        ks[1, Tk // 2:] = 0
        qs = onp.ones((2, Tq), "int32")
        qs[0, 0] = 9           # a row that sees nothing
        qs, ks = _t(qs).to(cuda), _t(ks).to(cuda)
    n0 = tk.flash_fwd_launches
    out, lse = tk.flash_attention(q, k, v, None, causal, qs, ks,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert tk.flash_fwd_launches == n0 + 1
    ref, ref_lse = tk.attention_plain(q, k, v, 1 / 8, causal, qs, ks)
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,seg", [
    (2, 3, 128, 128, 64, True, True),
    (1, 2, 100, 333, 64, False, False),
    (1, 2, 100, 333, 64, True, True),     # causal offset Tk - Tq
    (2, 2, 1000, 1000, 64, True, True),
    (1, 2, 77, 77, 128, True, False),
    (1, 1, 40, 60, 16, False, True),
])
def test_flash_bwd_kernels_match_plain_on_card(cuda, dtype, B, H, Tq, Tk,
                                               D, causal, seg):
    rng = onp.random.RandomState(9)
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(rng, B, H, Tq, Tk, D))
    g = _t(rng.randn(B, H, Tq, D).astype("float32")).to(cuda, dtype)
    qs = ks = None
    if seg:
        ks = onp.ones((B, Tk), "int32")
        ks[-1, Tk // 2:] = 0
        qs = onp.ones((B, Tq), "int32")
        qs[0, 0] = 9           # a row that sees nothing
        qs, ks = _t(qs).to(cuda), _t(ks).to(cuda)
    scale = 1 / D ** 0.5
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, causal)
    n0 = tk.launch_counts()
    got = tk.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale, causal)
    torch.cuda.synchronize()
    n1 = tk.launch_counts()
    assert n1["flash_bwd_dkv"] == n0["flash_bwd_dkv"] + 1
    assert n1["flash_bwd_dq"] == n0["flash_bwd_dq"] + 1
    want = tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale,
                                  causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        ref = float(b.float().abs().max())
        # fp32: 1e-4 absolute (sum order only); bf16: both round one fp32
        # value to 8 bits, so one bf16 step of the largest value
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * max(ref, 1.0)
        assert float((a.float() - b.float()).abs().max()) <= tol
    if seg:
        assert float(got[0][0, :, 0].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(32, 12), (8, 16)])
def test_flash_bwd_kernels_at_bert_training_shapes_on_card(cuda, dtype, B,
                                                           H):
    """BERT pretraining's backward (bench.py's Base and Large batches, T =
    128, D = 64): non-causal, q ids all 1, kv ids 112 of 128 valid and one
    row of length 0, at every legal tile; tolerances as above."""
    T, D = 128, 64
    rng = onp.random.RandomState(11)
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(rng, B, H, T, T, D))
    g = _t(rng.randn(B, H, T, D).astype("float32")).to(cuda, dtype)
    valid = onp.full(B, 112)
    valid[-1] = 0
    ks = _t((onp.arange(T)[None] < valid[:, None]).astype("int32")).to(cuda)
    qs = torch.ones_like(ks)
    scale = 1 / D ** 0.5
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, False)
    want = tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale,
                                  False)
    for bq in tk.FLASH_BLOCKS:
        for bk in tk.FLASH_BLOCKS:
            got = tk.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale,
                                    False, bq, bk)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                ref = float(b.float().abs().max())
                tol = 1e-4 if dtype == torch.float32 else \
                    2 ** -7 * max(ref, 1.0)
                assert float((a.float() - b.float()).abs().max()) <= tol, \
                    (bq, bk)
            # the length-0 row: no query sees a key, every gradient zero;
            # padded keys get none either
            for a in got:
                assert float(a[B - 1].float().abs().max()) == 0.0
            assert float(got[1][:, :, 112:].float().abs().max()) == 0.0
            assert float(got[2][:, :, 112:].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_flash_attention_autograd_runs_backward_kernels_on_card(cuda):
    rng = onp.random.RandomState(10)
    q, k, v = (_t(a).to(cuda).requires_grad_()
               for a in _qkv(rng, 2, 2, 96, 96, 32))
    g = _t(rng.randn(2, 2, 96, 32).astype("float32")).to(cuda)
    # a transposed (non-contiguous) output gradient, as the heads merge
    # hands it over
    g = g.transpose(1, 2).contiguous().transpose(1, 2)
    n0 = tk.launch_counts()
    out = tk.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), g)
    n1 = tk.launch_counts()
    assert [n1[n] - n0[n] for n in ("flash_fwd", "flash_bwd_dkv",
                                    "flash_bwd_dq")] == [1, 1, 1]
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(tk.flash_attention(qc, kc, vc, causal=True),
                               (qc, kc, vc), g.cpu())
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 768), (2000, 768), (37, 100)])
def test_layer_norm_kernel_matches_plain_on_card(cuda, rows, d):
    rng = onp.random.RandomState(8)
    x = _t(rng.randn(rows, d).astype("float32") * 2).to(cuda)
    g = _t(rng.randn(d).astype("float32")).to(cuda)
    b = _t(rng.randn(d).astype("float32")).to(cuda)
    n0 = tk.layer_norm_launches
    out = tk.fused_layer_norm(x, g, b)
    torch.cuda.synchronize()
    assert tk.layer_norm_launches == n0 + 1
    ref = tk.layer_norm_plain(x, g, b, 1e-5)
    assert float((out - ref).abs().max()) <= 1e-5


# -- fused softmax: the Pallas kernel in interpret mode / jax.nn.softmax ----
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", [
    (200, 256),        # d % 128 == 0: the Pallas kernel, ragged rows padded
    (4, 50, 128),      # 3-D, the Pallas kernel
    (37, 100),         # d % 128 != 0: the reference takes jax.nn.softmax
    (7, 1000),
])
def test_fused_softmax_matches_reference(monkeypatch, shape, dtype, tol):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas_kernels import fused_softmax

    rng = onp.random.RandomState(11)
    x = (rng.randn(*shape) * 3).astype("float32")
    gy = rng.randn(*shape).astype("float32")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, vjp = jax.vjp(fused_softmax, jnp.asarray(x, jdt))
    (want_g,) = vjp(jnp.asarray(gy, jdt))
    tdt = getattr(torch, dtype)
    xt = _t(x).to(tdt).requires_grad_()
    got = tk.fused_softmax(xt)
    assert got.dtype == tdt
    plain = tk.softmax_plain(_t(x).to(tdt))
    (got_g,) = torch.autograd.grad(got, xt, _t(gy).to(tdt))
    want = onp.asarray(want, "float32")
    want_g = onp.asarray(want_g, "float32")
    for a in (got, plain):
        err = onp.abs(a.detach().float().numpy() - want)
        assert float(err.max()) <= tol
        if dtype == "bfloat16":
            # also relative to each row's largest value: at wide rows the
            # values are far below 1e-2, so the absolute limit alone would
            # pass zeros (the reference's jax.nn.softmax path computes in
            # bf16 itself, hence a row scale and not an elementwise one)
            assert float((err / onp.abs(want).max(-1, keepdims=True))
                         .max()) <= 1e-2
    err_g = onp.abs(got_g.float().numpy() - want_g)
    assert float(err_g.max()) <= tol
    if dtype == "bfloat16":
        assert float((err_g / onp.abs(want_g).max(-1, keepdims=True))
                     .max()) <= 2e-2


def test_softmax_wrapper_refuses_host_tensors_and_counts_nothing_on_cpu():
    x = torch.randn(4, 8)
    with pytest.raises(MXNetError, match="CUDA device"):
        tk.softmax_cuda(x)
    before = tk.launch_counts()
    y = tk.fused_softmax(x)
    assert torch.allclose(y.sum(-1), torch.ones(4))
    assert tk.launch_counts() == before
    # a pinned tile outside the legal set is refused on either device
    with pytest.raises(MXNetError, match="block_rows"):
        tk.fused_layer_norm(x, torch.ones(8), torch.zeros(8), block_rows=3)
    with pytest.raises(MXNetError, match="block_rows"):
        tk.fused_softmax(x, block_rows=64)
    with pytest.raises(MXNetError, match="block_q=128"):
        tk.flash_attention(x[None, None], x[None, None], x[None, None],
                           block_q=128)


# -- on the card: every legal tile of every kernel against its plain version --
def _ragged_ids(B, T, cuda):
    # padding ids on the second batch row and a query row that sees no key
    ks = onp.ones((B, T), "int32")
    ks[1, 70:] = 0
    qs = ks.copy()
    qs[0, 5] = 9
    return _t(qs).to(cuda), _t(ks).to(cuda)


def _bf16_step(ref):
    # both sides round one fp32 value to 8 bits: one bf16 step of the
    # largest value
    return 2 ** -7 * max(float(ref.float().abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", tk.FLASH_BLOCKS)
@pytest.mark.parametrize("block_q", tk.FLASH_BLOCKS)
def test_flash_kernels_match_plain_at_every_tile_on_card(cuda, block_q,
                                                         block_k, D, dtype):
    # ragged T = 100 (no tile divides it), causal, padding ids and a row
    # that sees no key; every head-dim class of the kernels; D = 128 with
    # 64-row tiles needs dynamic shared memory past 48 KiB. fp32 within
    # 1e-4; bf16 within one bf16 step of the largest value (LSE 1e-4)
    rng = onp.random.RandomState(12)
    B, H, T = 2, 3, 100
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(rng, B, H, T, T, D))
    g = _t(rng.randn(B, H, T, D).astype("float32")).to(cuda, dtype)
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    tk.reset_launch_counts()
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, True, block_q,
                                 block_k)
    got = tk.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale, True,
                            block_q, block_k)
    torch.cuda.synchronize()
    tile = (block_q, block_k)
    assert tk.tile_counts() == {("flash_fwd", tile): 1,
                                ("flash_bwd_dkv", tile): 1,
                                ("flash_bwd_dq", tile): 1}
    f32 = dtype == torch.float32
    ref, ref_lse = tk.attention_plain(q, k, v, scale, True, qs, ks)
    assert float((out.float() - ref.float()).abs().max()) <= (
        1e-4 if f32 else _bf16_step(ref))
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    want = tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale, True)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - b.float()).abs().max()) <= (
            1e-4 if f32 else _bf16_step(b))
    assert float(got[0][0, :, 5].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", tk.FLASH_BLOCKS)
@pytest.mark.parametrize("block_q", tk.FLASH_BLOCKS)
def test_flash_fwd_bf16_matches_plain_at_every_tile_on_card(cuda, block_q,
                                                            block_k, D):
    # the one-product (bf16) instance of every tile, inputs as above
    rng = onp.random.RandomState(15)
    B, H, T = 2, 3, 100
    q, k, v = (_t(a).to(cuda, torch.bfloat16)
               for a in _qkv(rng, B, H, T, T, D))
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    tk.reset_launch_counts()
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, True, block_q,
                                 block_k)
    torch.cuda.synchronize()
    assert tk.tile_counts() == {("flash_fwd", (block_q, block_k)): 1}
    ref, ref_lse = tk.attention_plain(q, k, v, scale, True, qs, ks)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - ref.float()).abs().max()) <= _bf16_step(ref)
    # the scores are exact products of bf16 values summed in fp32
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    assert float(out[0, :, 5].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset", [(48, 0), (99, 0), (100, 0), (64, 1)])
def test_flash_fwd_staging_paths_on_card(cuda, dtype, D, offset):
    # K/V rows of 16-byte multiples from 16-byte aligned operands are
    # staged by cp.async, the rest by plain loads: D = 48 fills part of the
    # 64 class (both dtypes by cp.async); D = 99 (fp32 396 bytes, bf16 198)
    # and bf16 D = 100 (200 bytes) take the plain path, fp32 D = 100 (400
    # bytes) cp.async; offset 1 puts K and V one element past an aligned
    # address, so both dtypes take the plain path at D = 64
    rng = onp.random.RandomState(16)
    B, H, T = 2, 3, 100
    qn, kn, vn = _qkv(rng, B, H, T, T, D)
    q = _t(qn).to(cuda, dtype)

    def shifted(a):
        buf = torch.empty(a.size + offset, dtype=dtype, device=cuda)
        t = buf[offset:].view(a.shape)
        t.copy_(_t(a))
        return t

    k, v = shifted(kn), shifted(vn)
    assert k.is_contiguous() and (k.data_ptr() % 16 != 0) == bool(offset)
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, True)
    torch.cuda.synchronize()
    ref, ref_lse = tk.attention_plain(q, k, v, scale, True, qs, ks)
    tol = 1e-4 if dtype == torch.float32 else _bf16_step(ref)
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    assert float(out[0, :, 5].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset", [(48, 0), (99, 0), (100, 0), (64, 1)])
def test_flash_bwd_dq_staging_paths_on_card(cuda, dtype, D, offset):
    # the dQ kernel stages K/V as the forward does: cp.async for rows of
    # 16-byte multiples from 16-byte aligned operands, plain loads for the
    # rest (fp32 and bf16 D = 99, bf16 D = 100, every operand one element
    # past an aligned address); D = 48 fills part of the 64 class
    rng = onp.random.RandomState(17)
    B, H, T = 2, 3, 100
    qn, kn, vn = _qkv(rng, B, H, T, T, D)
    gn = rng.randn(B, H, T, D).astype("float32")

    def shifted(a):
        buf = torch.empty(a.size + offset, dtype=dtype, device=cuda)
        t = buf[offset:].view(a.shape)
        t.copy_(_t(a))
        return t

    q, k, v, g = (shifted(a) for a in (qn, kn, vn, gn))
    assert k.is_contiguous() and (k.data_ptr() % 16 != 0) == bool(offset)
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    out, lse = tk.attention_plain(q, k, v, scale, True, qs, ks)
    delta = (g.float() * out.float()).sum(dim=-1)
    n0 = tk.flash_bwd_dq_launches
    dq = tk.flash_bwd_dq_cuda(q, k, v, g, lse, delta, qs, ks, scale, True)
    torch.cuda.synchronize()
    assert tk.flash_bwd_dq_launches == n0 + 1 and dq.dtype == dtype
    want = tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale,
                                  True)[0]
    tol = 1e-4 if dtype == torch.float32 else _bf16_step(want)
    assert float((dq.float() - want.float()).abs().max()) <= tol
    assert float(dq[0, :, 5].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", tk.ROW_BLOCKS)
def test_row_kernels_match_plain_at_every_tile_on_card(cuda, block_rows):
    rng = onp.random.RandomState(13)
    tk.reset_launch_counts()
    for rows, d in ((37, 768), (1, 100)):
        x = _t(rng.randn(rows, d).astype("float32") * 2).to(cuda)
        g = _t(rng.randn(d).astype("float32")).to(cuda)
        b = _t(rng.randn(d).astype("float32")).to(cuda)
        out = tk.layer_norm_cuda(x, g, b, 1e-5, block_rows)
        sm = tk.softmax_cuda(x, block_rows)
        torch.cuda.synchronize()
        assert float((out - tk.layer_norm_plain(x, g, b, 1e-5)).abs()
                     .max()) <= 1e-5
        assert float((sm - tk.softmax_plain(x)).abs().max()) <= 1e-6
    assert tk.tile_counts() == {("layer_norm", (block_rows,)): 2,
                                ("softmax", (block_rows,)): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows,d", [(4096, 768), (64, 50257), (1, 768),
                                    (1001, 768), (3, 5)])
def test_softmax_kernel_matches_plain_on_card(cuda, dtype, tol, rows, d):
    rng = onp.random.RandomState(14)
    x = _t(rng.randn(rows, d).astype("float32") * 4).to(cuda, dtype) \
        .requires_grad_()
    gy = _t(rng.randn(rows, d).astype("float32")).to(cuda, dtype)
    n0 = tk.softmax_launches
    y = tk.fused_softmax(x)
    (gx,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert tk.softmax_launches == n0 + 1 and y.dtype == dtype
    ref = tk.softmax_plain(x.detach())
    diff = (y.detach().float() - ref.float()).abs()
    assert float(diff.max()) <= tol
    if dtype == torch.bfloat16:
        # one bf16 ulp of the value: the absolute limit alone would pass a
        # kernel that wrote zeros at vocabulary width
        assert bool((diff <= 8e-3 * ref.float().abs() + 1e-7).all())
    yr = ref.float()
    want = (gy.float() - (gy.float() * yr).sum(-1, keepdim=True)) * yr
    assert float((gx.float() - want).abs().max()) <= tol * 10


@pytest.mark.cuda
def test_library_lowering_is_taken_only_when_the_tier_chooses_it(cuda):
    from mxnet_tpu_torch import tune

    rng = onp.random.RandomState(15)
    q, k, v = (_t(a).to(cuda).requires_grad_()
               for a in _qkv(rng, 2, 2, 64, 64, 32))
    qs = torch.ones((2, 64), dtype=torch.int32, device=cuda)
    qs[0, 3] = 7                         # a row that sees no key
    ks = torch.ones_like(qs)
    x = _t(rng.randn(37, 96).astype("float32")).to(cuda)
    gam, bet = torch.ones(96, device=cuda), torch.zeros(96, device=cuda)
    with torch.no_grad():
        want = [tk.flash_attention(q, k, v, causal=True, q_segment_ids=qs,
                                   kv_segment_ids=ks),
                tk.fused_layer_norm(x, gam, bet), tk.fused_softmax(x)]
    tk.reset_launch_counts()
    with tune.override("flash_fwd", "xla"), \
            tune.override("layer_norm", "xla"), \
            tune.override("softmax", "xla"):
        out = tk.flash_attention(q, k, v, causal=True, q_segment_ids=qs,
                                 kv_segment_ids=ks)
        got = [out, tk.fused_layer_norm(x, gam, bet), tk.fused_softmax(x)]
    assert tk.library_counts() == {"flash_fwd": 1, "flash_bwd": 0,
                                   "layer_norm": 1, "softmax": 1}
    assert sum(tk.launch_counts().values()) == 0
    for a, b in zip(got, want):
        assert float((a.detach() - b).abs().max()) <= 1e-4
    assert float(out[0, :, 3].abs().max()) == 0.0
    # the backward's own family: kernel forward, library backward
    with tune.override("flash_bwd", "xla"):
        out = tk.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    assert tk.library_counts()["flash_bwd"] == 1
    assert tk.launch_counts()["flash_fwd"] == 1
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        tk.flash_attention(qc, kc, vc, causal=True).sum(), (qc, kc, vc))
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-4


# -- on the card: the tensor-core dK/dV kernel --------------------------------
def _dkv_case(cuda, dtype, D, offset=0, seed=18):
    """Ragged Tq = 70 < Tk = 100 (causal offset 30), padding ids, query row
    5 with an id no key has, keys 90-99 with an id no query has; every
    operand ``offset`` elements past a 16-byte boundary. Returns the
    kernel's arguments up to the tile and the plain dk, dv."""
    rng = onp.random.RandomState(seed)
    B, H, Tq, Tk = 2, 3, 70, 100
    qn, kn, vn = _qkv(rng, B, H, Tq, Tk, D)
    gn = rng.randn(B, H, Tq, D).astype("float32")

    def shifted(a):
        buf = torch.empty(a.size + offset, dtype=dtype, device=cuda)
        t = buf[offset:].view(a.shape)
        t.copy_(_t(a))
        return t

    q, k, v, g = (shifted(a) for a in (qn, kn, vn, gn))
    ks = onp.ones((B, Tk), "int32")
    ks[1, 70:] = 0
    ks[:, 90:] = 3
    qs = onp.ones((B, Tq), "int32")
    qs[1, 50:] = 0
    qs[0, 5] = 9
    qs, ks = _t(qs).to(cuda), _t(ks).to(cuda)
    scale = 1 / D ** 0.5
    out, lse = tk.attention_plain(q, k, v, scale, True, qs, ks)
    delta = (g.float() * out.float()).sum(dim=-1)
    want = tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, scale,
                                  True)[1:]
    return (q, k, v, g, lse, delta, qs, ks, scale, True), want


def _check_dkv(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == dtype
        tol = 1e-4 if dtype == torch.float32 else _bf16_step(b)
        assert float((a.float() - b.float()).abs().max()) <= tol
        # keys 90-99 are seen by no query: exact zeros
        assert float(a[:, :, 90:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", tk.FLASH_BLOCKS)
@pytest.mark.parametrize("block_q", tk.FLASH_BLOCKS)
def test_flash_bwd_dkv_matches_plain_at_every_tile_on_card(cuda, block_q,
                                                           block_k, D,
                                                           dtype):
    # every tile and head-dim class of the tensor-core dK/dV kernel, fp32
    # (3xTF32) within 1e-4, bf16 within one bf16 step of the largest value;
    # D = 128 puts K in planes beside V's where both fit (all tiles but
    # fp32 64 x 64, which re-reads K from L1)
    args, want = _dkv_case(cuda, dtype, D)
    tk.reset_launch_counts()
    got = tk.flash_bwd_dkv_cuda(*args, block_q, block_k)
    torch.cuda.synchronize()
    assert tk.tile_counts() == {("flash_bwd_dkv", (block_q, block_k)): 1}
    _check_dkv(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,offset", [(48, 0), (99, 0), (100, 0), (64, 1)])
def test_flash_bwd_dkv_staging_paths_on_card(cuda, dtype, D, offset):
    # Q and G tiles go through the cp.async ring for rows of 16-byte
    # multiples from 16-byte aligned operands, plain loads for the rest
    # (fp32 and bf16 D = 99, bf16 D = 100, every operand one element past
    # an aligned address); D = 48 fills part of the 64 class
    args, want = _dkv_case(cuda, dtype, D, offset, seed=19)
    assert (args[0].data_ptr() % 16 != 0) == bool(offset)
    n0 = tk.flash_bwd_dkv_launches
    got = tk.flash_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    assert tk.flash_bwd_dkv_launches == n0 + 1
    _check_dkv(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_dkv_is_deterministic_on_card(cuda, dtype):
    # each key's sums run in a fixed order with no atomics: two launches
    # are bitwise equal, at the training shape's width
    rng = onp.random.RandomState(20)
    q, k, v = (_t(a).to(cuda, dtype) for a in _qkv(rng, 2, 4, 256, 256, 64))
    g = _t(rng.randn(2, 4, 256, 64).astype("float32")).to(cuda, dtype)
    out, lse = tk.flash_fwd_cuda(q, k, v, None, None, 0.125, True)
    delta = (g.float() * out.float()).sum(dim=-1)
    args = (q, k, v, g, lse, delta, None, None, 0.125, True)
    first = tk.flash_bwd_dkv_cuda(*args)
    second = tk.flash_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# -- on the card: the fused softmax's wide path (one cluster a row) -----------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [
    (1, 50257, 0), (64, 50257, 0), (64, 50257, 1), (3, 4095, 0),
    (3, 4096, 0), (5, 4097, 1), (2, 8191, 0), (7, 4103, 3),
    (1, 600001, 0),
])
def test_softmax_wide_path_matches_plain_on_card(cuda, dtype, rows, d,
                                                 offset):
    # both sides of the wide path's threshold (d >= 4096: 4095 runs one warp
    # a row, 4096 one cluster a row); odd widths put every other row and
    # the slice boundaries off 16-byte boundaries, and ``offset`` shifts x
    # itself (out, from empty_like, then lies at another alignment than x:
    # scalar stores); 600001 is too wide for a block's shared memory (the
    # slice is read again from L2)
    rng = onp.random.RandomState(21)
    buf = torch.empty(rows * d + offset, dtype=dtype, device=cuda)
    x = buf[offset:].view(rows, d)
    x.copy_(_t(rng.randn(rows, d).astype("float32") * 4))
    n0 = tk.softmax_launches
    y = tk.softmax_cuda(x)
    torch.cuda.synchronize()
    assert tk.softmax_launches == n0 + 1 and y.dtype == dtype
    ref = tk.softmax_plain(x)
    diff = (y.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-6
    else:
        # one bf16 ulp of the value
        assert bool((diff <= 8e-3 * ref.float().abs() + 1e-7).all())
