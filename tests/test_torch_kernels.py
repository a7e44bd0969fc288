"""PyTorch/CUDA port: the two kernel modules and the attention op against
the JAX package.

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
    before = tk.launch_counts()
    tk.fused_layer_norm(x, g, b)
    tk.flash_attention(q, q, q)
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
