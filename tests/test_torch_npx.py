"""PyTorch/CUDA port: ``mx.npx`` against the JAX package's, on the CPU.

The same numpy inputs (``RandomState``) go through each ``npx`` op of both
packages; values, dtypes and the gradients of a seeded head gradient are
compared. The attention ops run on the grid of
``tests/test_attention_models.py`` (causal, padding mask routed to segment
ids, GQA, a dense mask); the reference's flash path runs as its own tests
run it on the CPU, the port's through its plain version. Also here: the
out-of-range behaviour of ``pick`` and ``embedding`` (indices -n-1, -n, -1,
n-1 and n) through both ops and ``SoftmaxCrossEntropyLoss``, and GPT through
the NDArray door against the reference's GPT on the same weights.
Tolerances, each with its reason:

- elementwise and normalisation ops: rtol 1e-5, atol 1e-6 in value, 1e-5 /
  1e-5 in gradient (the same fp32 formulas, sums in another order);
- attention: 1e-5 / 1e-5 in value and gradient (online softmax against the
  plain one, T <= 8);
- GPT: the loss rtol 1e-5; every parameter's gradient within 1e-5 of its
  largest entry (as ``tests/test_torch_train.py``);
- out-of-range fills (NaN, the int32 minimum): exact.
"""
import numpy as onp
import pytest
import torch

from torch_parity import VOCAB, twin_gpt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import nn as tnn

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref():
    import mxnet_tpu as mx

    return mx


def _run(mx, op, arrays, kwargs, wrt, head):
    xs = [mx.np.array(a) if isinstance(a, onp.ndarray) else a
          for a in arrays]
    kwargs = {k: mx.np.array(v) if isinstance(v, onp.ndarray) else v
              for k, v in kwargs.items()}
    for i in wrt:
        xs[i].attach_grad()
    with mx.autograd.record():
        y = getattr(mx.npx, op)(*xs, **kwargs)
    if wrt:
        y.backward(mx.np.array(head))
    return y, [xs[i].grad for i in wrt]


def _close(want, got, tol):
    assert dtype_name(got.dtype) == dtype_name(want.dtype), \
        (got.dtype, want.dtype)
    w, g = want.asnumpy(), got.asnumpy()
    assert g.shape == w.shape
    if w.dtype.kind == "f":
        onp.testing.assert_allclose(g, w, equal_nan=True, **tol)
    else:
        onp.testing.assert_array_equal(g, w)


def _both(op, arrays, kwargs=None, wrt=(0,), val=VAL, grad=GRAD, seed=0):
    kwargs = kwargs or {}
    shape = _run(tmx, op, arrays, kwargs, (), None)[0].shape
    head = onp.random.RandomState(seed).randn(*shape).astype("float32")
    yj, gj = _run(_ref(), op, arrays, kwargs, wrt, head)
    yt, gt = _run(tmx, op, arrays, kwargs, wrt, head)
    _close(yj, yt, val)
    for w, g in zip(gj, gt):
        _close(w, g, grad)


R = onp.random.RandomState(1)
X = R.randn(3, 8).astype("float32")
X3 = R.randn(2, 3, 4).astype("float32")
W = R.randn(5, 12).astype("float32")
W4 = R.randn(5, 4).astype("float32")
BIAS = R.randn(5).astype("float32")
G8 = R.uniform(0.5, 1.5, 8).astype("float32")
B8 = R.randn(8).astype("float32")
MASK = (R.rand(3, 8) > 0.3).astype("float32")
LEN = onp.array([8, 3, 5], "int32")
TABLE = R.randn(6, 4).astype("float32")
IDX = onp.array([[0, 5, 2], [1, 1, 4]], "int32")
PICK = onp.array([7, 0, 3], "int32")
U = R.uniform(-0.9, 0.9, (3, 8)).astype("float32")


# -- the NN ops: value and gradient --------------------------------------------
NN = [
    ("fully_connected", [X3, W, BIAS], {"num_hidden": 5}, (0, 1, 2)),
    ("fully_connected", [X3, W4], {"num_hidden": 5, "no_bias": True,
                                   "flatten": False}, (0, 1)),
    ("layer_norm", [X, G8, B8], {}, (0, 1, 2)),
    ("layer_norm", [X, G8[:3], B8[:3]], {"axis": 0, "eps": 1e-3}, (0, 1, 2)),
    ("leaky_relu", [X], {"slope": 0.1}, (0,)),
    ("leaky_relu", [X], {"act_type": "elu", "slope": 0.7}, (0,)),
    ("leaky_relu", [X], {"act_type": "selu"}, (0,)),
    ("leaky_relu", [X], {"act_type": "gelu"}, (0,)),
    ("leaky_relu", [X], {"act_type": "gelu_tanh"}, (0,)),
    ("leaky_relu", [X, G8], {"act_type": "prelu"}, (0, 1)),
    ("relu", [X], {}, (0,)), ("sigmoid", [X], {}, (0,)),
    ("softmax", [X], {}, (0,)), ("softmax", [X], {"axis": 0}, (0,)),
    ("softmax", [X], {"temperature": 2.0}, (0,)),
    ("softmax", [X], {"length": LEN}, (0,)),
    ("log_softmax", [X], {}, (0,)),
    ("log_softmax", [X], {"temperature": 0.5, "axis": 0}, (0,)),
    ("masked_softmax", [X, MASK], {}, (0,)),
    ("masked_softmax", [X, MASK], {"temperature": 3.0}, (0,)),
    ("embedding", [IDX, TABLE], {"input_dim": 6, "output_dim": 4}, (1,)),
    ("pick", [X, PICK], {}, (0,)),
    ("pick", [X, PICK[:1].repeat(8)], {"axis": 0, "keepdims": True}, (0,)),
    ("erf", [X], {}, (0,)), ("erfinv", [U], {}, (0,)),
    ("slice_axis", [X3], {"axis": 2, "begin": 1, "end": 3}, (0,)),
    ("slice_axis", [X3], {"axis": 0, "begin": -1, "end": None}, (0,)),
    ("slice_like", [X3, X3[:1, :2, :3]], {}, (0,)),
    ("slice_like", [X3, X3[:1, :2, :3]], {"axes": (1,)}, (0,)),
    ("cast", [X], {"dtype": "float32"}, (0,)),
    ("reshape_like", [X3, X[:, :8]], {}, (0,)),
    ("broadcast_like", [X[:1], X], {}, (0,)),
]
NN += [("activation", [X], {"act_type": a}, (0,)) for a in (
    "relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
    "mish", "hard_sigmoid", "hard_swish", "silu")]


@pytest.mark.parametrize("op,arrays,kw,wrt", NN,
                         ids=[f"{n}-{i}" for i, (n, *_) in enumerate(NN)])
def test_nn_ops_value_and_gradient(op, arrays, kw, wrt):
    _both(op, arrays, kw, wrt)


VALUE_ONLY = [
    ("one_hot", [IDX, 6], {}), ("one_hot", [IDX, 4],
                                {"on_value": 3.0, "off_value": -1.0}),
    ("topk", [X], {"k": 3}), ("topk", [X], {"k": 2, "ret_typ": "value",
                                            "axis": 0}),
    ("topk", [X], {"k": 2, "ret_typ": "both", "is_ascend": True}),
    ("cast", [X], {"dtype": "int32"}), ("cast", [X], {"dtype": "float64"}),
    ("cast", [X], {"dtype": "bfloat16"}),
    ("arange_like", [X3], {}), ("arange_like", [X3], {"start": 2.0,
                                                      "step": 0.5,
                                                      "axis": 1}),
    ("gamma", [onp.abs(X) + 0.5], {}), ("gammaln", [onp.abs(X) + 0.5], {}),
    ("stop_gradient", [X], {}),
    ("rfft", [X], {}), ("fft", [X], {"axis": 0}),
]


@pytest.mark.parametrize("op,arrays,kw", VALUE_ONLY,
                         ids=[f"{n}-{i}" for i, (n, *_) in
                              enumerate(VALUE_ONLY)])
def test_npx_ops_value(op, arrays, kw):
    mx = _ref()
    want = getattr(mx.npx, op)(*[mx.np.array(a) if isinstance(
        a, onp.ndarray) else a for a in arrays], **kw)
    got = getattr(tnpx, op)(*[tnp.array(a) if isinstance(
        a, onp.ndarray) else a for a in arrays], **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        if w.asnumpy().dtype.kind == "c":
            onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **GRAD)
            assert dtype_name(g.dtype) == dtype_name(w.dtype)
        else:
            _close(w, g, VAL)


def test_dropout_semantics_match():
    """Both packages draw their own masks from their own generators, so the
    masks differ; the semantics are compared: the identity outside
    ``record()``, inverted dropout inside it and with ``mode="always"``."""
    mx = _ref()
    x = onp.abs(R.randn(64, 64)).astype("float32") + 0.1
    for m in (mx, tmx):
        a = m.np.array(x)
        onp.testing.assert_array_equal(m.npx.dropout(a, p=0.3).asnumpy(), x)
        with m.autograd.record():
            on = m.npx.dropout(a, p=0.3).asnumpy()
        always = m.npx.dropout(a, p=0.3, mode="always").asnumpy()
        for out in (on, always):
            kept = out != 0
            onp.testing.assert_allclose(out[kept], x[kept] / 0.7, rtol=1e-6)
            assert 0.55 < kept.mean() < 0.85
        assert dtype_name(m.npx.dropout(a, p=0.3).dtype) == "float32"


# -- attention, on the grid of tests/test_attention_models.py ------------------
ATT = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_value_and_gradients(causal):
    rs = onp.random.RandomState(2)
    q, k, v = (rs.randn(2, 2, 8, 4).astype("float32") for _ in range(3))
    _both("flash_attention", [q, k, v], {"causal": causal}, (0, 1, 2),
          ATT, ATT)


MHA = [
    ("causal", {"causal": True}, None, 2),
    ("full", {}, None, 2),
    ("padding-to-segments", {}, "pad", 2),
    ("padding-causal", {"causal": True}, "pad", 2),
    ("gqa", {"num_kv_heads": 1, "causal": True}, None, 1),
    ("gqa-padding", {"num_kv_heads": 1}, "pad", 1),
    ("dense-mask", {}, "dense", 2),
    ("dense-mask-causal", {"causal": True}, "dense", 2),
]


@pytest.mark.parametrize("name,kw,mask,kv_heads", MHA,
                         ids=[m[0] for m in MHA])
def test_multihead_attention_grid(name, kw, mask, kv_heads):
    rs = onp.random.RandomState(3)
    B, T, H, D = 2, 8, 2, 4
    q = rs.randn(B, T, H * D).astype("float32")
    k, v = (rs.randn(B, T, kv_heads * D).astype("float32") for _ in "kv")
    arrays = [q, k, v]
    if mask == "pad":
        valid = onp.array([T, 5])
        arrays.append((onp.arange(T)[None] < valid[:, None])
                      .reshape(B, 1, 1, T).astype("float32"))
    elif mask == "dense":
        arrays.append((rs.rand(B, 1, T, T) > 0.3).astype("float32"))
    _both("multihead_attention", arrays, dict(num_heads=H, **kw), (0, 1, 2),
          ATT, ATT)


# -- out of range: pick, embedding, the loss (ROADMAP C1, C2) ------------------
N = 4
OOR = onp.array([-N - 1, -N, -1, N - 1, N], "int32")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pick_out_of_range_matches_reference(dtype):
    mx = _ref()
    x = (R.randn(5, N) * 10).astype(dtype)
    want = mx.npx.pick(mx.np.array(x), mx.np.array(OOR)).asnumpy()
    got = tnpx.pick(tnp.array(x), tnp.array(OOR))
    assert dtype_name(got.dtype) == dtype
    onp.testing.assert_array_equal(got.asnumpy(), want)
    door = tnn.pick(torch.from_numpy(x), torch.from_numpy(OOR))
    onp.testing.assert_array_equal(door.numpy(), want)
    if dtype == "float32":
        assert onp.isnan(want[[0, 4]]).all() and not onp.isnan(
            want[1:4]).any()
        onp.testing.assert_array_equal(want[1:4], x[[1, 2, 3], [0, 3, 3]])


def test_pick_out_of_range_gives_no_gradient_there():
    mx = _ref()
    x = R.randn(5, N).astype("float32")
    grads = []
    for m in (mx, tmx):
        a = m.np.array(x)
        a.attach_grad()
        with m.autograd.record():
            y = m.npx.pick(a, m.np.array(OOR))
            s = (m.np.where(m.np.isnan(y), 0.0, y) * 2).sum()
        s.backward()
        grads.append(a.grad.asnumpy())
    onp.testing.assert_array_equal(grads[1], grads[0])


def test_embedding_out_of_range_matches_reference():
    mx = _ref()
    w = R.randn(N, 3).astype("float32")
    want = mx.npx.embedding(mx.np.array(OOR), mx.np.array(w)).asnumpy()
    got = tnpx.embedding(tnp.array(OOR), tnp.array(w))
    onp.testing.assert_array_equal(got.asnumpy(), want)
    door = tnn.embedding(torch.from_numpy(OOR), torch.from_numpy(w))
    onp.testing.assert_array_equal(door.numpy(), want)
    assert onp.isnan(want[[0, 4]]).all()
    onp.testing.assert_array_equal(want[1:4], w[[0, 3, 3]])
    wi = onp.arange(N * 2, dtype="int32").reshape(N, 2)
    onp.testing.assert_array_equal(
        tnpx.embedding(tnp.array(OOR), tnp.array(wi)).asnumpy(),
        mx.npx.embedding(mx.np.array(OOR), mx.np.array(wi)).asnumpy())


def test_softmax_cross_entropy_out_of_range_labels_match_reference():
    mx = _ref()
    from mxnet_tpu.gluon import loss as jloss

    pred = R.randn(5, N).astype("float32")
    want = jloss.SoftmaxCrossEntropyLoss()(mx.np.array(pred),
                                           mx.np.array(OOR)).asnumpy()
    got = tloss.SoftmaxCrossEntropyLoss()(tnp.array(pred), tnp.array(OOR))
    assert isinstance(got, tnp.ndarray)
    onp.testing.assert_allclose(got.asnumpy(), want, equal_nan=True, **VAL)
    door = tloss.SoftmaxCrossEntropyLoss()(torch.from_numpy(pred),
                                           torch.from_numpy(OOR))
    onp.testing.assert_allclose(door.numpy(), want, equal_nan=True, **VAL)
    assert onp.isnan(want[[0, 4]]).all() and onp.isfinite(want[1:4]).all()


# -- GPT through the NDArray door ----------------------------------------------
def test_gpt_through_the_ndarray_door_matches_reference():
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import loss as jloss

    jnet, tnet = twin_gpt(seed=21)
    rs = onp.random.RandomState(5)
    toks = rs.randint(1, VOCAB, size=(3, 12)).astype("int32")
    tgt = rs.randint(1, VOCAB, size=(3, 12)).astype("int32")
    vl = onp.array([12, 7, 12], "int32")
    logits = tnet(tnp.array(toks), tnp.array(vl))
    assert isinstance(logits, tnp.ndarray)
    assert not logits._data.requires_grad     # nothing recorded outside
    with mx.autograd.record():
        jlogits = jnet(mx.np.array(toks), mx.np.array(vl))
        jl = jloss.SoftmaxCrossEntropyLoss()(jlogits, mx.np.array(tgt))
    jl.backward()
    onp.testing.assert_allclose(logits.asnumpy(), jlogits.asnumpy(),
                                rtol=1e-5, atol=1e-5)
    with tag.record():
        tl = tloss.SoftmaxCrossEntropyLoss()(
            tnet(tnp.array(toks), tnp.array(vl)), tnp.array(tgt))
    tl.backward()
    onp.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=1e-5)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for n in jp:
        want = jp[n].grad().asnumpy()
        got = tp[n].grad.numpy()
        scale = max(float(onp.abs(want).max()), 1e-6)
        assert float(onp.abs(got - want).max()) <= 1e-5 * scale, n


# -- framework controls and what is not ported ---------------------------------
def test_framework_controls():
    assert tnpx.set_np() and tnpx.is_np_array() and tnpx.is_np_shape()
    f = tnpx.use_np(lambda: 3)
    assert f() == 3
    tnpx.waitall()
    assert tnpx.cpu() == tmx.cpu() and tnpx.gpu(1) == tmx.Context("gpu", 1)
    assert tnpx.num_gpus() == torch.cuda.device_count()
    # __getattr__: any other registered op by name
    out = tnpx.log1p(tnp.array(onp.abs(X)))
    onp.testing.assert_allclose(out.asnumpy(), onp.log1p(onp.abs(X)),
                                rtol=1e-6)
    with pytest.raises(AttributeError):
        tnpx.no_such_op  # noqa: B018


@pytest.mark.parametrize("name", ["deconvolution", "sequence_reverse",
                                  "box_iou", "roi_align", "box_nms", "upsampling",
                                  "sequence_mask", "foreach"])
def test_ops_left_for_a9_raise(name):
    """These ops were left for ROADMAP A9 and are ported now (held to the
    JAX package in tests/test_torch_vision_ops.py and
    tests/test_torch_control_flow.py): each is a function of its own, no
    longer the stub; ``custom`` still raises naming A10."""
    fn = getattr(tnpx, name)
    assert "_not_ported" not in fn.__qualname__
    assert fn.__module__.startswith("mxnet_tpu_torch.numpy_extension")
    with pytest.raises(MXNetError, match="A10"):
        tnpx.custom(tnp.array(X))
