"""PyTorch/CUDA port: the Symbol API, deferred compute, ``CachedOp`` over a
Symbol and the ``Executor``, against the JAX package, on the CPU.

The cases of ``tests/test_symbol.py`` (composition, the namespace's op
builders and CamelCase names, ``bind`` forward and backward,
``simple_bind``, bind errors, ``Group`` and the JSON, ``infer_shape``) and
of ``tests/test_cached_op.py`` (trace and replay, constant capture, several
outputs, autograd, fresh random numbers every call, the JSON round trip,
``list_arguments``, nested blocks inline, boolean masks refused,
``lower_hlo``), each run in both packages on the same numpy inputs (drawn
from a seed), with the port's values held to the JAX package's. Also: each
package loads the other's Symbol JSON, ``AttrScope``/``NameManager``, the
recorder's refusals (an unmapped torch call, an in-place write, an unknown
op in a loaded graph), ``visualization``, and on the card the Executor's
outputs and gradients against the same graph on the CPU.

Tolerance: rtol/atol 1e-5 (fp32 results of the same ops in another
library); counts and shapes exactly.

The JAX package is imported inside the tests that use it, so ``pytest
--noconftest tests/test_torch_symbol.py -m cuda`` collects this file on a
machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.symbol as tsym
from mxnet_tpu_torch import MXNetError, autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.cached_op import CachedOp, trace
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.symbol import Symbol, topo_sort

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _close(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else onp.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else onp.asarray(want)
    onp.testing.assert_allclose(got, want, **TOL)


def _draw(*shapes, seed=0):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*s).astype("float32") for s in shapes]


def _jax():
    import mxnet_tpu as mx
    import mxnet_tpu.symbol as jsym

    return mx, jsym


# -- tests/test_symbol.py -----------------------------------------------------
def test_symbolic_composition():
    _, jsym = _jax()
    for S in (tsym, jsym):
        a, b = S.var("a"), S.var("b")
        d = S.exp(S.matmul(a, b)) + a
        assert set(d.list_arguments()) == {"a", "b"}


def test_symbol_namespace_ops():
    _, jsym = _jax()
    for S in (tsym, jsym):
        a = S.var("a")
        assert S.softmax(S.relu(a), axis=-1).list_arguments() == ["a"]
        w = S.var("w")
        fc = S.FullyConnected(a, w, num_hidden=4, no_bias=True)
        assert set(fc.list_arguments()) == {"a", "w"}
    assert tsym.FullyConnected(tsym.var("x"), tsym.var("w"), num_hidden=4,
                               no_bias=True)._entries[0][0].op.name == \
        "fully_connected"
    with pytest.raises(AttributeError):
        tsym.NoSuchOp


def test_bind_forward():
    mx, jsym = _jax()
    av, bv, av2 = _draw((2, 3), (3, 4), (2, 3))
    outs = []
    for S, np_ in ((tsym, tnp), (jsym, mx.np)):
        c = S.matmul(S.var("a"), S.var("b"))
        ex = c.bind(args={"a": np_.array(av), "b": np_.array(bv)})
        first = ex.forward()[0].asnumpy()
        second = ex.forward(a=np_.array(av2))[0].asnumpy()
        outs.append((first, second))
    (t1, t2), (j1, j2) = outs
    _close(t1, j1)
    _close(t2, j2)
    _close(t1, av @ bv)


def test_bind_backward():
    mx, jsym = _jax()
    av = onp.array([1.0, 2.0, 3.0], "float32")
    got = {}
    for key, S, np_ in (("t", tsym, tnp), ("j", jsym, mx.np)):
        out = S.sum(S.multiply(S.var("a"), S.var("a")))
        a, g = np_.array(av), np_.zeros((3,))
        ex = out.bind(args={"a": a}, args_grad={"a": g})
        y = ex.forward(is_train=True)[0]
        ex.backward(np_.array(onp.array(1.0, "float32")))
        got[key] = (y.asnumpy(), ex.arg_dict["a"].grad.asnumpy())
    _close(got["t"][0], 14.0)
    _close(got["t"][0], got["j"][0])
    _close(got["t"][1], got["j"][1])
    _close(got["t"][1], 2 * av)


def test_simple_bind():
    ex = (tsym.var("a") + tsym.var("b")).simple_bind(a=(2, 2), b=(2, 2))
    out = ex.forward()
    assert out[0].shape == (2, 2)
    assert ex.arg_dict["a"].shape == (2, 2)
    assert float(abs(out[0].asnumpy()).sum()) == 0.0


def test_bind_errors():
    c = tsym.var("a") + tsym.var("b")
    with pytest.raises(MXNetError):
        c.bind(args={"a": tnp.ones((2,))})
    with pytest.raises(MXNetError):
        c.simple_bind(a=(2,))
    with pytest.raises(MXNetError, match="expected 2 args"):
        c.bind(args=[tnp.ones((2,))])
    with pytest.raises(MXNetError, match="args_grad has 1"):
        c.bind(args=[tnp.ones((2,)), tnp.ones((2,))],
               args_grad=[tnp.zeros((2,))])


def test_group_and_json():
    mx, jsym = _jax()
    outs = []
    for S, np_ in ((tsym, tnp), (jsym, mx.np)):
        a = S.var("a")
        g = S.Group([a * 2, a + 1])
        ex = g.bind(args={"a": np_.array([1.0, 2.0])})
        o1, o2 = ex.forward()
        outs.append((o1.asnumpy(), o2.asnumpy()))
        g2 = S.fromjson(g.tojson())
        assert len(g2) == 2
    assert outs[0][0].tolist() == [2.0, 4.0] == outs[1][0].tolist()
    assert outs[0][1].tolist() == [2.0, 3.0] == outs[1][1].tolist()


def test_infer_shape_api():
    mx, jsym = _jax()
    for S in (tsym, jsym):
        a, w = S.var("a"), S.var("w")
        out = S.FullyConnected(a, w, num_hidden=8, no_bias=True)
        args, out_shapes, aux = out.infer_shape(a=(4, 16), w=(8, 16))
        assert out_shapes[0] == (4, 8) and aux == []
        assert [tuple(s) for s in args] == [(4, 16), (8, 16)]
    # an op without meta-device support (the flash kernel's wrapper) runs
    # on CPU zeros instead
    q, k, v = (tsym.var(n) for n in "qkv")
    fa = Symbol.apply_op("flash_attention", q, k, v)
    assert fa.infer_shape(q=(1, 2, 8, 4), k=(1, 2, 8, 4),
                          v=(1, 2, 8, 4))[1] == [(1, 2, 8, 4)]
    with pytest.raises(MXNetError, match="missing shape"):
        fa.infer_shape(q=(1, 2, 8, 4))


def test_json_crosses_between_the_packages():
    """A graph written by either package runs in the other to the same
    values (constants, literals, tuple attributes, two outputs)."""
    mx, jsym = _jax()
    xv, = _draw((2, 3, 4), seed=3)
    for S in (tsym, jsym):
        x = S.var("x")
        y = S.reshape(S.exp(x) * 0.5 - 1.0, newshape=(2, 12))
        g = S.Group([S.sum(y, axis=1), S.transpose(x, axes=(0, 2, 1))])
        js = g.tojson()
        t = tsym.fromjson(js).bind(args={"x": tnp.array(xv)}).forward()
        j = jsym.fromjson(js).bind(args={"x": mx.np.array(xv)}).forward()
        for a, b in zip(t, j):
            _close(a, b)


# -- tests/test_cached_op.py --------------------------------------------------
def test_trace_and_replay():
    mx, _ = _jax()
    from mxnet_tpu.cached_op import trace as jtrace

    xv, wv, x2 = (onp.array([[1.0, 2.0], [3.0, 4.0]], "float32"),
                  onp.eye(2, dtype="float32"),
                  onp.array([[5.0, 6.0], [7.0, 8.0]], "float32"))
    got = []
    for tr, np_ in ((trace, tnp), (jtrace, mx.np)):
        w = np_.array(wv)

        def fn(a):
            return (a @ w + 1).sum(axis=1)

        _, _, cop = tr(fn, [np_.array(xv)], [("w", w)])
        got.append(cop(np_.array(x2), w).asnumpy())
    _close(got[0], got[1])
    _close(got[0], (x2 + 1).sum(axis=1))


def test_const_capture():
    x = tnp.array([1.0, 2.0])

    def fn(a):
        c = tnp.array([10.0, 20.0])     # made inside the forward: a const
        return a + c

    _, _, cop = trace(fn, [x], [], transform=lambda s: s)
    consts = [n for n in topo_sort(cop.sym._entries) if n.is_const]
    assert len(consts) == 1
    _close(cop(tnp.array([1.0, 1.0])), [11.0, 21.0])
    # a torch tensor made without traced inputs is a const too
    _, _, cop = trace(lambda a: a + torch.arange(2), [torch.ones(2)], [],
                      transform=lambda s: s)
    _close(cop(torch.full((2,), 5.0)), [5.0, 6.0])


def test_multi_output():
    x = tnp.array([[1.0, 2.0]])
    for transform in (None, lambda s: s):
        _, _, cop = trace(lambda a: (a * 2, a + 1), [x], [],
                          transform=transform)
        o1, o2 = cop(x)
        _close(o1, [[2.0, 4.0]])
        _close(o2, [[2.0, 3.0]])
        assert len(cop.sym) == 2


def test_cached_op_autograd():
    mx, _ = _jax()
    from mxnet_tpu.cached_op import trace as jtrace

    grads = []
    for tr, np_, ag in ((trace, tnp, tag), (jtrace, mx.np, mx.autograd)):
        _, _, cop = tr(lambda a: (a * a).sum(), [np_.array([1.0, 2, 3])],
                       [], transform=lambda s: s)
        inp = np_.array([2.0, 3.0, 4.0])
        inp.attach_grad()
        with ag.record():
            y = cop(inp)
        y.backward()
        grads.append(inp.grad.asnumpy())
    _close(grads[0], grads[1])
    _close(grads[0], [4.0, 6.0, 8.0])


def test_rng_fresh_per_call():
    x = tnp.ones((50, 50))

    def fn(a):
        with tag.train_mode():
            return tnpx.dropout(a, p=0.5)

    _, _, cop = trace(fn, [x], [], transform=lambda s: s)
    assert cop._uses_rng
    assert [n.op.name for n in topo_sort(cop.sym._entries) if n.op] == \
        ["dropout"]
    a, b = cop(x).asnumpy(), cop(x).asnumpy()
    assert not onp.allclose(a, b), "dropout mask must differ per call"
    assert set(onp.unique(a)) <= {0.0, 2.0}


def test_symbol_json_roundtrip():
    """The traced graph's JSON, loaded by each package, gives the traced
    op's values."""
    mx, jsym = _jax()
    from mxnet_tpu.cached_op import CachedOp as JCachedOp
    from mxnet_tpu.symbol.symbol import topo_sort as jtopo

    xv = onp.array([[1.0, -2.0]], "float32")
    x = tnp.array(xv)
    _, _, cop = trace(lambda a: tnpx.activation(a * 2 + 1, act_type="relu"),
                      [x], [])
    js = cop.sym.tojson()
    sym2 = Symbol.fromjson(js)
    cop2 = CachedOp(sym2, [n for n in topo_sort(sym2._entries) if n.is_var])
    _close(cop2(x), cop(x))
    jsym2 = jsym.fromjson(js)
    jcop = JCachedOp(jsym2, [n for n in jtopo(jsym2._entries) if n.is_var])
    _close(cop(x), jcop(mx.np.array(xv)))
    assert [n.op.name for n in topo_sort(sym2._entries) if n.op] == \
        ["multiply", "add", "activation"]


def test_symbol_infer_shape():
    c = Symbol.apply_op("matmul", tsym.var("a"), tsym.var("b"))
    _, out_shapes, _ = c.infer_shape(a=(2, 3), b=(3, 5))
    assert out_shapes[0] == (2, 5)


def test_symbol_list_arguments():
    a, b = tsym.var("a"), tsym.var("b")
    assert set(((a + b) * a).list_arguments()) == {"a", "b"}
    assert len((a + b).list_outputs()) == 1
    assert len((a * b).get_internals()) == 3


def test_trace_rejects_boolean_mask():
    x = tnp.array([1.0, -1.0, 2.0])
    with pytest.raises(MXNetError, match="data-dependent"):
        trace(lambda a: a[a > 0], [x], [], transform=lambda s: s)


def test_nested_hybrid_blocks_inline():
    inner = tnn.Dense(4, in_units=3)
    outer = tnn.HybridSequential()
    outer.add(inner, tnn.Dense(2, in_units=4))
    outer.initialize(seed=1)
    inner.hybridize()
    outer.hybridize()
    x = tnp.array(_draw((2, 3))[0])
    out = outer(x)
    assert out.shape == (2, 2)
    ops = [n.op.name for n in topo_sort(
        next(iter(outer._cached.values()))[0].sym._entries) if n.op]
    assert ops == ["fully_connected", "fully_connected"]
    assert inner._cached == {}


def test_lower_hlo():
    x = tnp.ones((2, 2))
    _, _, cop = trace(lambda a: a + 1, [x], [])
    text = cop.lower_hlo(x)
    g = Symbol.fromjson(text)
    assert [n.op.name for n in topo_sort(g._entries) if n.op] == ["add"]
    lowered = cop.lower(x)
    prog = lowered.compile()
    _close(prog(x)[0], onp.full((2, 2), 2.0))


def test_lower_hlo_rng_graph():
    x = tnp.ones((4, 4))
    _, _, cop = trace(lambda a: a + tnp.random.uniform(size=a.shape), [x],
                      [])
    assert cop._uses_rng
    g = Symbol.fromjson(cop.lower_hlo(x))
    names = [n.op.name for n in topo_sort(g._entries) if n.op]
    assert names[-1] == "add" and len(names) == 2
    assert g._entries[0][0].inputs[1][0].op.needs_rng


# -- scopes, the recorder's refusals, visualization ---------------------------
def test_attr_scope_and_name_manager():
    with tmx.AttrScope(group="4", lr_mult="0.1"):
        a = tsym.var("a")
        with tmx.AttrScope(group="5"):
            b = tsym.var("b", shape=(2, 3))
    assert a.attr("group") == "4" and a.attr("lr_mult") == "0.1"
    assert b.list_attr() == {"group": "5", "lr_mult": "0.1",
                             "__shape__": "(2, 3)"}
    with tmx.name.Prefix("enc_"):
        c = tsym.exp(a)
        v = tsym.var()
    assert c.name.startswith("enc_exp") and v.name.startswith("enc_var")
    with tmx.NameManager():
        assert tsym.exp(a).name == "exp0"


_W = torch.from_numpy(_draw((5, 4), seed=9)[0])
_TORCH_CALLS = {
    "add": (lambda x, y: x + y, "add"),
    "radd": (lambda x, y: 2.0 + x, "add"),
    "sub": (lambda x, y: x - y, "subtract"),
    "rsub": (lambda x, y: 1.0 - x, "subtract"),
    "mul": (lambda x, y: x * 0.5, "multiply"),
    "div": (lambda x, y: x / (y.abs() + 1), "true_divide"),
    "rdiv": (lambda x, y: 1.0 / (x.abs() + 1), "true_divide"),
    "pow": (lambda x, y: x ** 2, "power"),
    "matmul": (lambda x, y: x @ y.transpose(1, 2), "matmul"),
    "torch_matmul": (lambda x, y: torch.matmul(x, y.mT), "matmul"),
    "less": (lambda x, y: (x < y).float(), "less"),
    "greater_equal": (lambda x, y: (x >= y).to(torch.float32),
                      "greater_equal"),
    "equal": (lambda x, y: (x == x).float(), "equal"),
    "not_equal": (lambda x, y: (x != y).float(), "not_equal"),
    "bitwise_and": (lambda x, y: ((x > 0) & (y > 0)).float(),
                    "bitwise_and"),
    "neg": (lambda x, y: -x, "negative"),
    "abs": (lambda x, y: x.abs(), "abs"),
    "reshape": (lambda x, y: x.reshape(6, 4), "reshape"),
    "view": (lambda x, y: x.view(-1), "reshape"),
    "flatten": (lambda x, y: x.flatten(1), "flatten"),
    "unsqueeze": (lambda x, y: x.unsqueeze(1), "expand_dims"),
    "squeeze": (lambda x, y: x.unsqueeze(0).squeeze(0), "squeeze"),
    "t": (lambda x, y: x[0].t(), "transpose"),
    "T": (lambda x, y: x[0].T, "transpose"),
    "transpose": (lambda x, y: x.transpose(0, 2), "swapaxes"),
    "permute": (lambda x, y: x.permute(2, 0, 1), "transpose"),
    "expand": (lambda x, y: x[:, :1].expand(2, 3, -1), "broadcast_to"),
    "chunk": (lambda x, y: x.chunk(2, dim=-1)[1], "split"),
    "split": (lambda x, y: x.split([1, 2], dim=1)[1], "split"),
    "cat": (lambda x, y: torch.cat([x, y], 1), "concatenate"),
    "stack": (lambda x, y: torch.stack([x, y], 0), "stack"),
    "getitem": (lambda x, y: x[:, 1:, ::2], "slice_key"),
    "getitem_int": (lambda x, y: x[1, None, -1], "slice_key"),
    "where": (lambda x, y: torch.where(x > 0, x, y), "where"),
    "masked_fill": (lambda x, y: x.masked_fill(y > 0, 0.0), "where"),
    "to_int": (lambda x, y: (x * 3).to(torch.int32), "astype"),
    "long": (lambda x, y: (x * 3).long(), "astype"),
    "type_as": (lambda x, y: (x > 0).type_as(y), "astype"),
    "clone": (lambda x, y: x.clone(), "copy"),
    "detach": (lambda x, y: x.detach() + y, "stop_gradient"),
    "contiguous": (lambda x, y: x.transpose(0, 1).contiguous(), "swapaxes"),
    "sum": (lambda x, y: x.sum(dim=1), "sum"),
    "mean": (lambda x, y: x.mean(-1, keepdim=True), "mean"),
    "amax": (lambda x, y: x.amax(-1), "max"),
    "softmax": (lambda x, y: torch.softmax(x, -1), "softmax"),
    "functional_softmax": (lambda x, y: torch.nn.functional.softmax(x, 1),
                           "softmax"),
    "log_softmax": (lambda x, y: x.log_softmax(-1), "log_softmax"),
    "clamp": (lambda x, y: x.clamp(-0.5, 0.5), "clip"),
    "clamp_min": (lambda x, y: x.clamp_min(0.1), "clip"),
    "einsum": (lambda x, y: torch.einsum("bij,bkj->bik", x, y), "einsum"),
    "gelu": (lambda x, y: torch.nn.functional.gelu(x), "leaky_relu"),
    "gelu_tanh": (lambda x, y: torch.nn.functional.gelu(
        x, approximate="tanh"), "leaky_relu"),
    "linear": (lambda x, y: torch.nn.functional.linear(x, _W),
               "fully_connected"),
    "relu": (lambda x, y: torch.relu(x), "activation"),
    "sigmoid": (lambda x, y: torch.sigmoid(x), "activation"),
    "tanh": (lambda x, y: x.tanh(), "tanh"),
    "exp": (lambda x, y: x.exp(), "exp"),
    "log": (lambda x, y: (x.abs() + 1).log(), "log"),
    "sqrt": (lambda x, y: x.abs().sqrt(), "sqrt"),
    "ones_like": (lambda x, y: torch.ones_like(x) + x, "ones_like"),
    "zeros_like": (lambda x, y: torch.zeros_like(x) + y, "zeros_like"),
}


@pytest.mark.parametrize("case", sorted(_TORCH_CALLS))
def test_recorder_maps_torch_calls(case):
    """A raw torch call on traced tensors is recorded as its registry op,
    and the graph's executor on new inputs gives what torch gives."""
    fn, op_name = _TORCH_CALLS[case]
    x, y, x2, y2 = (torch.from_numpy(a) for a in _draw(*[(2, 3, 4)] * 4,
                                                         seed=4))
    _, _, cop = trace(fn, [x, y], [], transform=lambda s: s)
    assert op_name in [n.op.name for n in topo_sort(cop.sym._entries)
                       if n.op], case
    want = fn(x2, y2)
    got = cop(x2, y2)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                                rtol=1e-6, atol=1e-6)


class _Unmapped(HybridBlock):
    def forward(self, x):
        return torch.cumsum(x, dim=0)


class _InPlace(HybridBlock):
    def forward(self, x):
        y = x * 2
        y += 1
        return y


def test_recorder_refuses_unmapped_and_in_place_calls(tmp_path):
    x = torch.ones(2, 3)
    for blk, match in ((_Unmapped(), "'cumsum'"), (_InPlace(), "in place")):
        blk.hybridize()
        want = blk(x)
        with pytest.raises(MXNetError, match=match):
            blk.export(str(tmp_path / "m"))
        with pytest.raises(MXNetError, match=match):
            blk.optimize_for(x, backend="default")
        blk.hybridize()
        assert torch.equal(blk(x), want)
    # a host read of a traced value is an unmapped call too
    with pytest.raises(MXNetError, match="'item'"):
        trace(lambda a: a * a.sum().item(), [x], [], transform=lambda s: s)


def test_unknown_op_and_attribute_raise():
    js = tsym.exp(tsym.var("x")).tojson().replace('"exp"', '"no_such_op"')
    with pytest.raises(MXNetError, match="no_such_op"):
        tsym.fromjson(js)
    bad = Symbol.apply_op("activation", tsym.var("x"), act_type="relu",
                          bogus=1)
    with pytest.raises(MXNetError, match="bogus"):
        bad.bind(args={"x": tnp.ones((2,))})


def test_print_summary_and_plot_network(capsys):
    a, w = tsym.var("a"), tsym.var("w")
    s = tsym.Activation(tsym.FullyConnected(a, w, num_hidden=4,
                                            no_bias=True), act_type="relu")
    text = tmx.visualization.print_summary(s)
    assert "fully_connected" in text and "activation" in text
    dot = tmx.viz.plot_network(s, title="mlp")
    assert dot.startswith('digraph "mlp"') and dot.count("->") == 3
    net = tnn.Dense(4, in_units=3)
    net.initialize(seed=0)
    assert "Total params: 16" in tmx.visualization.print_summary(net)
    capsys.readouterr()


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mlp_symbol():
    x, w1, b1, w2, b2 = (tsym.var(n) for n in ("x", "w1", "b1", "w2", "b2"))
    h = tsym.Activation(tsym.FullyConnected(x, w1, b1, num_hidden=64),
                        act_type="relu")
    return tsym.FullyConnected(h, w2, b2, num_hidden=8)


@pytest.mark.cuda
def test_executor_on_the_card(cuda):
    """``simple_bind`` on the card, ``forward(is_train=True)`` and
    ``backward``: outputs and every argument's gradient against the same
    graph on the CPU (fp32 GEMMs in another order: 1e-5 of each tensor's
    largest entry)."""
    shapes = dict(x=(16, 32), w1=(64, 32), b1=(64,), w2=(8, 64), b2=(8,))
    vals = dict(zip(shapes, _draw(*shapes.values(), seed=5)))
    sym = _mlp_symbol()
    got = {}
    for dev, ctx in (("cpu", tmx.cpu()), ("cuda", tmx.gpu())):
        ex = sym.simple_bind(ctx=ctx, **shapes)
        out = ex.forward(is_train=True, **{
            n: tnp.array(v, ctx=ex.arg_dict[n]._data.device)
            for n, v in vals.items()})[0]
        ex.backward(tnp.ones(out.shape, ctx=out._data.device))
        got[dev] = [out.asnumpy()] + [
            ex.arg_dict[n].grad.asnumpy() for n in shapes]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert float(abs(a - b).max()) <= 1e-5 * float(abs(b).max())
