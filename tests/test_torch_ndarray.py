"""PyTorch/CUDA port: NDArray, Context and the autograd tape over NDArrays,
against the JAX package on the CPU (after ``tests/test_ndarray.py``,
``tests/test_autograd.py`` and ``tests/test_higher_order_grad.py``).

Each test runs the same steps in both packages on the same numpy inputs and
compares what they give: values (rtol 1e-5, atol 1e-6: fp32 formulas in
another order; higher-order gradients rtol 1e-5, atol 1e-5), dtypes and
shapes, and the same errors (:class:`MXNetError` in both). Tests marked
``cuda`` run on the card and skip without one.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.base import dtype_name

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref():
    import mxnet_tpu as mx

    return mx


def _pkgs():
    return [("ref", _ref()), ("port", tmx)]


def _same(fn):
    """``fn(mx)`` in both packages; returns (reference's, port's)."""
    return fn(_ref()), fn(tmx)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else x


def _eq(pair, tol=TOL):
    want, got = (_host(v) for v in pair)
    if isinstance(want, list):
        for w, g in zip(want, got):
            _eq((w, g), tol)
        return
    want, got = onp.asarray(want), onp.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    onp.testing.assert_allclose(got, want, **tol)


# -- NDArray semantics (tests/test_ndarray.py) ---------------------------------
def test_creation_dtypes_and_arithmetic():
    def f(mx):
        a = mx.np.array([[1, 2], [3, 4]])
        b = mx.np.array([[0.5, 1.5], [2.5, 3.5]], dtype="float64")
        return [a, b, a + b, a * 2, 2 - a, a / 2, a // 3, a % 3, -a, a ** 2,
                b @ b, abs(-b), a == 2, a >= 3, a.T, a + [1, 1],
                onp.ones(2, "int64") + a]

    _eq(_same(f))


def test_inplace_rebinds_and_keeps_other_handles():
    for _, mx in _pkgs():
        a = mx.np.array([1.0, 2.0])
        orig, view = a, a.detach()
        host = a.asnumpy()
        a += 1
        assert a is orig
        a *= 2
        a -= 1
        a /= 2
        onp.testing.assert_array_equal(a.asnumpy(), [1.5, 2.5])
        onp.testing.assert_array_equal(view.asnumpy(), [1.0, 2.0])
        onp.testing.assert_array_equal(host, [1.0, 2.0])


def test_asnumpy_is_an_owned_copy():
    a = tnp.array([1.0, 2.0])
    h = a.asnumpy()
    assert h.flags.owndata and h.flags.writeable
    h[0] = 9.0
    assert a.asnumpy()[0] == 1.0
    a += 1
    assert h[1] == 2.0
    src = onp.array([1.0, 2.0], "float32")
    b = tnp.array(src)
    src[0] = 7.0
    assert b.asnumpy()[0] == 1.0          # array() copies its input too


def test_bfloat16_behaves_as_the_reference():
    def f(mx):
        a = mx.np.array([1.0, 2.5, 3.1], dtype="bfloat16")
        return a, a * 2, a.astype("float32"), a.sum()

    want, got = _same(f)
    for w, g in zip(want, got):
        assert dtype_name(g.dtype) == dtype_name(w.dtype)
        hw, hg = w.asnumpy(), g.asnumpy()
        assert hg.dtype == hw.dtype       # ml_dtypes' bfloat16 on the host
        onp.testing.assert_array_equal(hg.astype("float32"),
                                       hw.astype("float32"))


def test_item_ctx_astype_copyto_and_conversions():
    for name, mx in _pkgs():
        a = mx.np.array([1.5, 2.5])
        assert a.ctx == mx.cpu() and a.ctx.device_type == "cpu"
        assert a.context == a.ctx and a.device == a.ctx
        assert a.as_in_ctx(mx.cpu()) is a
        b = a.astype("int32")
        assert dtype_name(b.dtype) == "int32" and b.tolist() == [1, 2]
        assert a.astype("float32", copy=False) is a
        assert a.astype("float32") is not a
        c = a.copy()
        c += 1
        assert a.tolist() == [1.5, 2.5]
        z = mx.np.zeros((2,), dtype="int32")
        assert a.copyto(z) is z and z.tolist() == [1, 2]
        assert dtype_name(z.dtype) == "int32"
        with pytest.raises(mx.MXNetError):
            a.copyto(a)
        assert mx.np.array([3.5]).item() == 3.5
        assert float(mx.np.array([3.5])) == 3.5 and int(
            mx.np.array([3])) == 3
        assert bool(mx.np.array([1]))
        with pytest.raises(ValueError):
            bool(mx.np.array([1, 2]))
        with pytest.raises(ValueError):
            mx.np.array([1, 2]).item()
        assert len(mx.np.zeros((3, 2))) == 3
        assert [r.tolist() for r in mx.np.arange(4).reshape((2, 2))] == \
            [[0, 1], [2, 3]], name
        assert a.shape == (2,) and a.ndim == 1 and a.size == 2
        assert a.itemsize == 4 and a.stype == "default"
        assert "1.5" in repr(a)


def test_methods_match_reference():
    x = onp.random.RandomState(0).randn(2, 3, 4).astype("float32")

    def f(mx):
        a = mx.np.array(x)
        return [a.reshape((6, 4)), a.reshape(4, 6), a.transpose(),
                a.transpose((2, 0, 1)), a.swapaxes(0, 2), a.flatten(),
                a.ravel(), a[:, :1].squeeze(1), a.expand_dims(0),
                a[0:1].broadcast_to((3, 3, 4)), a.tile((1, 2, 1)),
                a.repeat(2, 1), a.sum(), a.sum(axis=1, keepdims=True),
                a.mean(axis=(0, 2)), a.max(), a.min(axis=2), a.prod(axis=0),
                a.std(axis=1), a.var(ddof=1), a.argmax(axis=2),
                a.argmin(), a.cumsum(axis=1), a.clip(-0.5, 0.5),
                a.round(1), a.abs(), a[0].dot(a[1].T), a.norm(),
                a.take(mx.np.array([2, 0]), axis=1)] + \
            list(a.split(2, axis=2))

    _eq(_same(f), dict(rtol=1e-5, atol=1e-5))


def test_getitem_matches_reference():
    x = onp.arange(24, dtype="float32").reshape(2, 3, 4)

    def f(mx):
        a = mx.np.array(x)
        return [a[0], a[1, 2], a[:, 1], a[..., -1], a[0, :, None], a[::-1],
                a[:, ::2, 1:3], a[mx.np.array([1, 0, 1])],
                a[:, [0, 2]], a[mx.np.array([True, False])],
                a[a > 20], a[1, [0, 2], [1, 3]], a[-1, -1, -1]]

    _eq(_same(f))


def test_setitem_matches_reference_and_rebinds():
    def f(mx):
        a = mx.np.zeros((3, 4))
        before = a.detach()
        a[1] = 5.0
        a[0, 0] = 1.0
        a[:, 2] = mx.np.array([7.0, 8.0, 9.0])
        a[mx.np.array([0, 2]), 3] = -1.0
        a[a > 6] = 0.5
        a[..., 1:2] = [[2.0], [3.0], [4.0]]
        return [a, before]

    _eq(_same(f))


def test_setitem_and_inplace_raise_on_recorded_arrays():
    for _, mx in _pkgs():
        x = mx.np.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            with pytest.raises(mx.MXNetError):
                y += 1
            with pytest.raises(mx.MXNetError):
                x[0] = 3.0
        y += 1                          # outside record: allowed
        assert y.tolist() == [3.0, 5.0]


def test_wait_repr_and_waitall():
    a = tnp.ones((2, 2))
    assert a.wait_to_read() is a and a.wait_to_write() is a
    tnpx.waitall()
    tmx.waitall()


def test_context_value_semantics_and_scope():
    ctx = tmx.Context("gpu", 1)
    assert ctx == tmx.gpu(1) and ctx != tmx.gpu(0) and ctx != tmx.cpu(1)
    assert hash(ctx) == hash(tmx.gpu(1)) and repr(ctx) == "gpu(1)"
    assert tmx.device("cuda:1") == ctx and tmx.device("cpu") == tmx.cpu()
    assert tmx.device(torch.device("cpu")) == tmx.cpu()
    assert tmx.Device is tmx.Context
    with pytest.raises(MXNetError):
        tmx.Context("tpu")
    assert tmx.current_context() == tmx.cpu()    # the autouse scope
    with tmx.gpu(3):
        assert tmx.current_context() == tmx.gpu(3)
    assert tmx.current_context() == tmx.cpu()
    assert tmx.resolve_device(tmx.cpu()) == torch.device("cpu")
    assert tmx.num_gpus() == torch.cuda.device_count()


def test_default_context_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default context is valid here")
    stack = tmx.Context._local.stack
    saved = list(stack)
    del stack[:]
    try:
        with pytest.raises(MXNetError, match="GPU is required"):
            tmx.current_context()
        with pytest.raises(MXNetError, match="GPU is required"):
            tnp.zeros((2,))
        with pytest.raises(MXNetError):
            tmx.gpu().torch_device  # noqa: B018
    finally:
        stack.extend(saved)


# -- autograd (tests/test_autograd.py) -----------------------------------------
def test_grad_req_write_add_and_null():
    def f(mx):
        out = []
        for req in ("write", "add", "null"):
            x = mx.np.array([2.0, -1.0])
            x.attach_grad(grad_req=req)
            for _ in range(3):
                with mx.autograd.record():
                    y = (x * x * x).sum()
                y.backward()
            out.append(x.grad)
        return out

    _eq(_same(f))


def test_backward_grad_and_head_grads():
    def f(mx):
        a = mx.np.array([1.0, 2.0])
        b = mx.np.array([3.0, 4.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = a * b + a
        y.backward(mx.np.array([1.0, 10.0]))
        ga, gb = a.grad.asnumpy(), b.grad.asnumpy()
        with mx.autograd.record():
            z = (a ** 3).sum()
        g = mx.autograd.grad(z, [a])[0]
        return [ga, gb, g, a.grad]        # grad() leaves x.grad alone

    _eq(_same(f))


def test_detach_stop_gradient_pause_and_mark_variables():
    def f(mx):
        x = mx.np.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            z = (y.detach() * x).sum() + (mx.npx.stop_gradient(y) * x).sum()
            with mx.autograd.pause():
                w = x * 100           # not recorded
            z = z + (w * 0).sum()
        z.backward()
        g1 = x.grad.asnumpy()
        v = mx.np.array([3.0])
        buf = mx.np.zeros((1,))
        mx.autograd.mark_variables([v], [buf])
        with mx.autograd.record():
            (v * v).sum().backward()
        return [g1, buf]

    _eq(_same(f))


def test_a_rebound_variable_stays_marked_with_its_gradient():
    def f(mx):
        x = mx.np.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            (x * x).sum().backward()
        first = x.grad.asnumpy()
        x += 1                        # rebinds, outside record()
        x[0] = 5.0
        kept = x.grad.asnumpy()
        with mx.autograd.record():
            (x * x * x).sum().backward()
        return [first, kept, x, x.grad]

    _eq(_same(f))


def test_nothing_is_recorded_outside_record():
    for _, mx in _pkgs():
        x = mx.np.array([1.0])
        x.attach_grad()
        y = x * 2
        with pytest.raises(mx.MXNetError):
            y.backward()
        with mx.autograd.record():
            with mx.autograd.pause():
                z = x * 2
        with pytest.raises(mx.MXNetError):
            z.backward()
        with pytest.raises(mx.MXNetError):
            mx.autograd.grad((x * 2).sum(), [mx.np.array([1.0])])
    assert not (tnp.array([1.0]) * 2)._data.requires_grad


def test_training_flags_and_dropout_scope():
    assert not tag.is_training() and not tag.is_recording()
    with tag.record():
        assert tag.is_training() and tag.is_recording()
        with tag.pause():
            assert not tag.is_recording()
        with tag.predict_mode():
            assert not tag.is_training()
    with tag.train_mode():
        assert tag.is_training() and not tag.is_recording()


def test_retain_graph_and_a_freed_graph():
    for _, mx in _pkgs():
        x = mx.np.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = (mx.np.exp(x)).sum()
        y.backward(retain_graph=True)
        first = x.grad.asnumpy()
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), first, rtol=1e-6)
        with pytest.raises(mx.MXNetError):
            y.backward()


def test_grad_through_indexing_concat_and_split():
    def f(mx):
        x = mx.np.array(onp.arange(6, dtype="float32").reshape(2, 3))
        x.attach_grad()
        with mx.autograd.record():
            a = x[1, 1:] * 3 + x[mx.np.array([0, 0])].sum(axis=0)[:2]
            parts = mx.np.split(mx.np.concatenate([x, x * 2], axis=1), 2,
                                axis=1)
            loss = (a * a).sum() + (parts[1] * parts[0]).sum()
        loss.backward()
        return x.grad

    _eq(_same(f))


# -- higher-order gradients (tests/test_higher_order_grad.py) ------------------
def _nth_grad(mx, fn, x_np, order):
    x = mx.np.array(x_np)
    x.attach_grad()
    with mx.autograd.record():
        y = fn(mx, x).sum()
        g = mx.autograd.grad(y, [x], create_graph=True)[0]
        for _ in range(order - 2):
            g = mx.autograd.grad(g.sum(), [x], create_graph=True)[0]
        s = g.sum()
    return mx.autograd.grad(s, [x])[0] if order > 1 else g


HIGHER = [
    ("cube", lambda mx, a: a ** 3, 2), ("sin", lambda mx, a: mx.np.sin(a), 2),
    ("exp", lambda mx, a: mx.np.exp(a), 2),
    ("log", lambda mx, a: mx.np.log(a), 2),
    ("sigmoid", lambda mx, a: 1 / (1 + mx.np.exp(-a)), 2),
    ("quartic-3rd", lambda mx, a: a ** 4, 3),
    ("sin-3rd", lambda mx, a: mx.np.sin(a), 3),
    ("tanh-3rd", lambda mx, a: mx.npx.activation(a, act_type="tanh"), 3),
    ("layer_norm-2nd", lambda mx, a: mx.npx.layer_norm(
        a.reshape((1, 3)), mx.np.ones((3,)), mx.np.zeros((3,))) ** 3, 2),
    ("flash-2nd", lambda mx, a: mx.npx.flash_attention(
        a.reshape((1, 1, 3, 1)), a.reshape((1, 1, 3, 1)),
        a.reshape((1, 1, 3, 1)), causal=True) ** 2, 2),
]


@pytest.mark.parametrize("fn,order", [h[1:] for h in HIGHER],
                         ids=[h[0] for h in HIGHER])
def test_higher_order_gradients_match_reference(fn, order):
    x = onp.array([0.5, 1.0, 1.5], "float32")
    want, got = (_nth_grad(mx, fn, x, order) for mx in (_ref(), tmx))
    _eq((want, got), dict(rtol=1e-5, atol=1e-5))


def test_grad_of_grad_multivar_and_create_graph_first_order():
    def f(mx):
        x = mx.np.array([1.0, 2.0])
        y = mx.np.array([3.0, 4.0])
        x.attach_grad()
        y.attach_grad()
        with mx.autograd.record():
            gx = mx.autograd.grad((x * y * y).sum(), [x],
                                  create_graph=True)[0]
            s = gx.sum()
        gy = mx.autograd.grad(s, [y])[0]
        return [gx, gy]

    _eq(_same(f))


# -- the compiled step takes NDArrays ------------------------------------------
def test_compiled_step_takes_ndarrays_and_returns_an_ndarray_loss():
    from torch_parity import VOCAB

    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny

    rs = onp.random.RandomState(4)
    x = rs.randint(1, VOCAB, (2, 8)).astype("int32")
    y = rs.randint(1, VOCAB, (2, 8)).astype("int32")
    losses = []
    for as_nd in (False, True):
        net = gpt_tiny(vocab_size=VOCAB, num_layers=1, units=16,
                       num_heads=2, dropout=0.0, device="cpu")
        net.initialize(seed=3)
        tr = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
        step = tr.compile_step(net, SoftmaxCrossEntropyLoss())
        conv = tnp.array if as_nd else torch.from_numpy
        out = [step(conv(x), conv(y)) for _ in range(2)]
        assert all(isinstance(o, tnp.ndarray) == as_nd for o in out)
        losses.append([float(o.mean()) if as_nd else float(o.mean())
                       for o in out])
    assert losses[0] == losses[1]


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_default_context_is_the_gpu(cuda):
    stack = tmx.Context._local.stack
    saved = list(stack)
    del stack[:]
    try:
        assert tmx.current_context() == tmx.gpu(torch.cuda.current_device())
        a = tnp.arange(4)
        assert a.ctx.device_type == "gpu" and a._data.is_cuda
        assert dtype_name(a.dtype) == "int32"
    finally:
        stack.extend(saved)


@pytest.mark.cuda
def test_wait_to_read_and_asnumpy_on_the_card(cuda):
    a = tnp.array(onp.arange(6, dtype="float32").reshape(2, 3), ctx=tmx.gpu())
    b = (a * 2 + 1).wait_to_read()
    h = b.asnumpy()
    assert h.flags.owndata
    onp.testing.assert_array_equal(h, onp.arange(6).reshape(2, 3) * 2 + 1)
    assert b.as_in_ctx(tmx.cpu()).ctx == tmx.cpu()
    tmx.waitall()


@pytest.mark.cuda
def test_embedding_out_of_range_on_the_card_leaves_the_process_usable(cuda):
    w = tnp.array(onp.arange(8, dtype="float32").reshape(4, 2),
                  ctx=tmx.gpu())
    idx = tnp.array([-5, -4, -1, 3, 4], ctx=tmx.gpu())
    out = tnpx.embedding(idx, w).asnumpy()
    assert onp.isnan(out[[0, 4]]).all()
    onp.testing.assert_array_equal(out[1:4], [[0, 1], [6, 7], [6, 7]])
    picked = tnpx.pick(w, tnp.array([1, -1, 9, -3], ctx=tmx.gpu()))
    onp.testing.assert_array_equal(picked.asnumpy(),
                                   [1.0, 3.0, onp.nan, onp.nan])
    after = (tnp.ones((3,), ctx=tmx.gpu()) * 2).asnumpy()   # still usable
    onp.testing.assert_array_equal(after, [2.0, 2.0, 2.0])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_second_order_through_the_kernels_on_the_card(cuda):
    """LayerNorm's backward is differentiable again and agrees with the
    CPU's; a gradient through the flash kernels with create_graph raises
    MXNetError (their backward kernels have no derivative), where the
    CPU's plain version gives the reference's second derivative
    (``test_higher_order_gradients_match_reference[flash-2nd]``)."""
    x = onp.array([0.5, 1.0, 1.5, -0.3], "float32")
    ln = (lambda mx, a: mx.npx.layer_norm(
        a.reshape((1, 4)), mx.np.ones((4,)), mx.np.zeros((4,))) ** 3)
    want = _nth_grad(tmx, ln, x, 2).asnumpy()
    with tmx.gpu():
        got = _nth_grad(tmx, ln, x, 2).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with tmx.gpu():
        q = tnp.array(onp.random.RandomState(0).randn(1, 1, 16, 64)
                      .astype("float32"))
        q.attach_grad()
        with tag.record():
            y = (tnpx.flash_attention(q, q, q, causal=True) ** 2).sum()
            with pytest.raises(MXNetError, match="create_graph"):
                tag.grad(y, [q], create_graph=True)
        g = tag.grad(y, [q])[0]            # first order: the kernels
        assert bool(torch.isfinite(g._data).all())
