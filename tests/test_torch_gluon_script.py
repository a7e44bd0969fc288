"""PyTorch/CUDA port: reference-style Gluon bodies against the JAX package.

A block body written as the reference's are (``mx.np``/``mx.npx`` on a
layer's output, ``Parameter.data()``, NDArray methods on its inputs) runs in
the port as in the JAX package, eagerly and hybridized, called with
NDArrays (the reference's way) and with tensors (the port's):

- five small bodies over ``Dense(3, in_units=4)`` (``mx.np.tanh``,
  ``npx.relu``, ``mx.np.sum(x) + fc(x)``, ``npx.slice_axis`` and a
  product with ``fc.weight.data()``): outputs and the gradients of ``x``,
  the weight and the bias. The hybridized ``tanh`` body called with a
  tensor is the case whose gradients came back as zeros before tensors
  were wrapped without a copy;
- a recorded call whose outputs are cut off from its inputs raises rather
  than handing back zeros;
- a hybridized body that makes a host constant (``mx.np.array(-1e30)``)
  runs, and on the card captures once and replays the eager values;
- ``tests/torch_script_gpt.py``'s ``ScriptGPT`` (the reference's GPT body
  with only its imports changed) at 2 layers, 64 units, 4 heads, vocab 50,
  T = 16, dropout 0, against the JAX package's ``GPTModel`` with the same
  weights (a ``.params`` file): logits, loss and every parameter's
  gradient, eager and hybridized, with and without ``valid_length``.

Tolerance: 1e-5 of each tensor's largest entry (fp32 sums in another
order, as ``tests/test_torch_train.py``'s GPT gradients); the port's
hybridized calls against its eager ones bitwise on the CPU (a CPU program
runs its body eagerly), and on the card within 1e-6 (the same kernels).
The JAX package is imported inside the tests that use it, so ``pytest
--noconftest ... -m cuda`` collects this file without JAX.
"""
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd as tag
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity import numpy_weights  # noqa: E402
from torch_script_gpt import ScriptGPT  # noqa: E402

TOL = 1e-5
BODIES = ("tanh", "relu", "sum_plus", "slice", "data")
GPT_CFG = dict(vocab_size=50, num_layers=2, units=64, num_heads=4,
               max_length=32, dropout=0.0)
GPT_T = 16
VALID = (16, 11)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np(x):
    if hasattr(x, "asnumpy"):
        return onp.asarray(x.asnumpy(), dtype="float64")
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return onp.asarray(x, dtype="float64")


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _body_block(pkg, kind, **kw):
    """A reference-style block of ``pkg`` (either package) over
    ``Dense(3, in_units=4)``."""
    np, npx = pkg.np, pkg.npx

    class Body(pkg.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = pkg.gluon.nn.Dense(3, in_units=4, **kw)

        def forward(self, x):
            y = self.fc(x)
            if kind == "tanh":
                return np.tanh(y)
            if kind == "relu":
                return npx.relu(y)
            if kind == "sum_plus":
                return np.sum(x) + y
            if kind == "slice":
                return npx.slice_axis(y, axis=-1, begin=1, end=3)
            return np.matmul(x, self.fc.weight.data().T) * y

    return Body()


X = onp.random.RandomState(4).randn(2, 4).astype("float32")


def _jax_body(kind, path, hybrid):
    import mxnet_tpu as mx

    net = _body_block(mx, kind)
    net.load_parameters(path)
    if hybrid:
        net.hybridize()
    x = mx.np.array(X)
    x.attach_grad()
    with mx.autograd.record():
        y = net(x)
        s = (y * y).sum()
    s.backward()
    return (y.asnumpy(), x.grad.asnumpy(), net.fc.weight.grad().asnumpy(),
            net.fc.bias.grad().asnumpy())


def _port_body(kind, path, hybrid, as_tensor):
    net = _body_block(tmx, kind)
    net.load_parameters(path)
    if hybrid:
        net.hybridize()
    if as_tensor:
        x = torch.from_numpy(X.copy()).requires_grad_()
    else:
        x = tmx.np.array(X)
        x.attach_grad()
    with tag.record():
        y = net(x)
        s = (y * y).sum()
    tag.backward(s)
    return (y, x.grad, net.fc.weight.grad(), net.fc.bias.grad())


@pytest.fixture(scope="module")
def body_refs(tmp_path_factory):
    """Each body's weights (one ``.params`` file) and the JAX package's
    outputs and gradients, eager and hybridized."""
    out = {}
    for i, kind in enumerate(BODIES):
        path = str(tmp_path_factory.mktemp("body") / f"{kind}.params")
        with tmx.cpu():
            net = _body_block(tmx, kind)
            net.initialize(seed=10 + i)
            net.save_parameters(path)
        out[kind] = (path, {h: _jax_body(kind, path, h)
                            for h in (False, True)})
    return out


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["ndarray", "tensor"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("kind", BODIES)
def test_reference_style_body_matches_jax(body_refs, kind, hybrid,
                                          as_tensor):
    path, refs = body_refs[kind]
    got = _port_body(kind, path, hybrid, as_tensor)
    for name, g, w in zip(("out", "x.grad", "weight.grad", "bias.grad"),
                          got, refs[hybrid]):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
    assert abs(_np(got[1])).max() > 0 and abs(_np(got[2])).max() > 0


def test_hybridized_matches_eager_bitwise(body_refs):
    for kind in BODIES:
        path, _ = body_refs[kind]
        eager = _port_body(kind, path, False, True)
        hybrid = _port_body(kind, path, True, True)
        for e, h in zip(eager, hybrid):
            assert onp.array_equal(_np(e), _np(h)), kind


def test_tensors_and_ndarrays_mix():
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    a = tmx.np.array([3.0, 4.0])
    with tag.record():
        outs = [t + a, a + t, t * a, torch.tanh(a) + t, tmx.np.tanh(t)]
        s = sum(o.sum() for o in outs)
    assert all(isinstance(o, tmx.nd.NDArray) for o in outs)
    tag.backward(s)
    # the sum is 3 t + t a + tanh(t) + terms without t
    want = 1 + 1 + onp.array([3.0, 4.0]) + 1 + \
        (1 - onp.tanh([1.0, 2.0]) ** 2)
    onp.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6)


class _Cut(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.fc = tmx.gluon.nn.Dense(3, in_units=4)

    def forward(self, x):
        return tmx.npx.stop_gradient(self.fc(x)) * 2.0


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_cut_recorded_call_raises(hybrid):
    net = _Cut()
    net.initialize(seed=1)
    if hybrid:
        net.hybridize()
    x = tmx.np.array(X)
    x.attach_grad()
    with tag.record():
        y = net(x).sum()
    with pytest.raises(MXNetError, match="connected"):
        y.backward()


def test_recorded_node_keeps_zeros_for_one_unused_input():
    class TwoIn(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = tmx.gluon.nn.Dense(3, in_units=4)

        def forward(self, x, unused):
            return self.fc(x)

    net = TwoIn()
    net.initialize(seed=2)
    net.hybridize()
    x, u = tmx.np.array(X), tmx.np.array(X)
    x.attach_grad()
    u.attach_grad()
    with tag.record():
        y = net(x, u).sum()
    y.backward()
    assert abs(x.grad.asnumpy()).max() > 0
    assert not u.grad.asnumpy().any()


def _masked_block(pkg, **kw):
    class Masked(pkg.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = pkg.gluon.nn.Dense(3, in_units=4, **kw)

        def forward(self, x, mask):
            y = self.fc(x)
            return pkg.np.where(mask, y,
                                pkg.np.array(-1e30, dtype="float32"))

    return Masked()


MASK = onp.array([[True, False, True], [False, True, True]])


def test_host_constant_in_a_hybridized_body(tmp_path):
    import mxnet_tpu as mx

    net = _masked_block(tmx)
    net.initialize(seed=3)
    path = str(tmp_path / "masked.params")
    net.save_parameters(path)
    eager = net(tmx.np.array(X), tmx.np.array(MASK))
    net.hybridize()
    got = [net(tmx.np.array(X), tmx.np.array(MASK)) for _ in range(2)]
    assert len(net._cached) == 1
    for g in got:
        assert onp.array_equal(g.asnumpy(), eager.asnumpy())
    jnet = _masked_block(mx)
    jnet.load_parameters(path)
    jnet.hybridize()
    want = jnet(mx.np.array(X), mx.np.array(MASK)).asnumpy()
    assert _rel(got[0], want) <= TOL


# -- ScriptGPT against the JAX package's GPTModel ----------------------------
def _gpt_batch():
    rs = onp.random.RandomState(7)
    tokens = rs.randint(0, GPT_CFG["vocab_size"], (2, GPT_T))
    labels = rs.randint(0, GPT_CFG["vocab_size"], (2, GPT_T))
    return tokens.astype("int32"), labels.astype("int32")


@pytest.fixture(scope="module")
def gpt_ref(tmp_path_factory):
    """The JAX ``GPTModel`` with numpy weights (saved to a ``.params``
    file): logits, loss and gradients without and with ``valid_length``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.gpt import GPTModel

    jnet = GPTModel(**GPT_CFG)
    jnet.initialize()
    params = jnet.collect_params()
    weights = numpy_weights({n: p.shape for n, p in params.items()}, 17)
    for n, p in params.items():
        p.set_data(mx.np.array(weights[n]))
    path = str(tmp_path_factory.mktemp("gpt") / "gpt.params")
    jnet.save_parameters(path)
    tokens, labels = _gpt_batch()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for valid in (False, True):
        vl = mx.np.array(VALID, dtype="int32") if valid else None
        with mx.autograd.record():
            logits = jnet(mx.np.array(tokens, dtype="int32"), vl)
            loss = loss_fn(logits, mx.np.array(labels, dtype="int32"))
            loss = loss.mean()
        loss.backward()
        out[valid] = (logits.asnumpy(), float(loss.asnumpy()),
                      {n: p.grad().asnumpy() for n, p in params.items()})
    return path, out


def _port_gpt(path, hybrid, valid):
    net = ScriptGPT(**GPT_CFG)
    net.load_parameters(path)
    if hybrid:
        net.hybridize()
    tokens, labels = _gpt_batch()
    vl = tmx.np.array(VALID, dtype="int32") if valid else None
    loss_fn = SoftmaxCrossEntropyLoss()
    with tag.record():
        logits = net(tmx.np.array(tokens, dtype="int32"), vl)
        loss = loss_fn(logits, tmx.np.array(labels, dtype="int32")).mean()
    loss.backward()
    return net, logits, loss


@pytest.mark.parametrize("valid", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_script_gpt_matches_jax(gpt_ref, hybrid, valid):
    path, ref = gpt_ref
    logits, loss, grads = ref[valid]
    net, got_logits, got_loss = _port_gpt(path, hybrid, valid)
    assert _rel(got_logits, logits) <= TOL
    assert abs(float(got_loss.asnumpy()) - loss) <= TOL * abs(loss)
    params = net.collect_params()
    assert list(params) == list(grads)
    for n, p in params.items():
        assert _rel(p.grad(), grads[n]) <= TOL, (n, _rel(p.grad(), grads[n]))
    # the tied embedding's gradient arrives by two routes (lookup, head)
    assert abs(_np(params["tok_embed.weight"].grad())).max() > 0
    if hybrid:
        (cop, _, _), = net._cached.values()
        assert cop._captures == 1


def test_script_gpt_hybridized_equals_eager(gpt_ref):
    path, _ = gpt_ref
    a, la, _ = _port_gpt(path, False, True)
    b, lb, _ = _port_gpt(path, True, True)
    assert onp.array_equal(la.asnumpy(), lb.asnumpy())
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        assert onp.array_equal(p.grad().asnumpy(), q.grad().asnumpy()), n


def test_script_gpt_names_are_the_ports_gpt():
    from mxnet_tpu_torch.gluon.model_zoo import GPTModel

    script = ScriptGPT(**GPT_CFG)
    port = GPTModel(device="cpu", **GPT_CFG)
    assert list(script.collect_params()) == list(port.collect_params())


# -- on the card ---------------------------------------------------------------
@pytest.mark.cuda
def test_host_constant_captured_once_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with tmx.gpu():
        net = _masked_block(tmx)
        net.initialize(seed=3)
        x, m = tmx.np.array(X), tmx.np.array(MASK)
        eager = net(x, m).asnumpy()
        net.hybridize()
        got = [net(x, m).asnumpy() for _ in range(3)]
        (cop, _, _), = net._cached.values()
        assert cop._captures == 1
        assert cop.graph_stats()[0]["replays"] == 3
        for g in got:
            assert onp.array_equal(g, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tanh", "data"])
def test_reference_style_body_on_the_card(kind, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = str(tmp_path / "body.params")
    net = _body_block(tmx, kind)
    net.initialize(seed=5)
    net.save_parameters(path)
    want = _port_body(kind, path, False, True)
    with tmx.gpu():
        for hybrid in (False, True):
            for as_tensor in (False, True):
                net = _body_block(tmx, kind)
                net.load_parameters(path)
                if hybrid:
                    net.hybridize()
                if as_tensor:
                    x = torch.from_numpy(X.copy()).cuda().requires_grad_()
                else:
                    x = tmx.np.array(X)
                    x.attach_grad()
                with tag.record():
                    y = net(x)
                    s = (y * y).sum()
                tag.backward(s)
                got = (y, x.grad, net.fc.weight.grad(), net.fc.bias.grad())
                for g, w in zip(got, want):
                    assert _rel(g, w) <= 1e-6
                    assert abs(_np(g)).max() > 0
