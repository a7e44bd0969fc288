"""PyTorch/CUDA port: ``npx.foreach``, ``npx.while_loop``, ``npx.cond`` and
the registered ``_foreach`` / ``_while_loop`` / ``_cond``, against the JAX
package on the CPU.

Each case runs the same body through both packages on the same seeded
numpy inputs, under ``autograd.record()`` where it has gradients, and holds
outputs, final states and the gradients into the explicit operands
(``data``, states, ``loop_vars``, ``inputs``) within ``RTOL`` (1e-6) of each
largest entry. An array the body captures by closure gets no gradient in
either package (its gradient buffer stays zeros), where a plain Python
loop over the tensors would give it one. The reference's own cases of
``tests/test_control_flow.py`` are among them.

The ``cuda`` tests run a 2-layer LSTM cell written in ``mx.np`` through
``foreach`` on the card, eagerly and hybridized (one CUDA graph), against
the CPU, and check that ``while_loop`` without ``max_iterations`` inside a
capture raises. The JAX package is imported inside the tests that use it,
so ``pytest --noconftest tests/test_torch_control_flow.py -m cuda``
collects this file on a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.gluon.block import HybridBlock as THybridBlock

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(abs(got - want).max(initial=0.0) /
                 max(abs(want).max(initial=0.0), 1e-30))


def _jax():
    from mxnet_tpu import autograd, np, npx

    return np, npx, autograd


def _torch():
    return tnp, tnpx, tag


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [] if x is None else [x]


def _run(case, pkg, seed=0):
    """The case's outputs and the gradients of sum(out * c) into its
    operands (and its captured array, which must get none), as numpy."""
    np_, npx_, ag = pkg
    rng = onp.random.RandomState(seed)
    ops, capture, fn = case(np_, npx_, rng)
    if getattr(case, "forward_only", False):
        return [o.asnumpy() for o in _flat(fn(*ops))], [], []
    for a in ops + capture:
        a.attach_grad()
    with ag.record():
        outs = _flat(fn(*ops))
        loss = None
        for o in outs:
            c = np_.array(onp.asarray(rng.randn(*o.shape), "float32"))
            t = (o * c).sum()
            loss = t if loss is None else loss + t
    loss.backward()
    return ([o.asnumpy() for o in outs], [a.grad.asnumpy() for a in ops],
            [a.grad.asnumpy() for a in capture])


def _arr(np_, rng, *shape):
    return np_.array(rng.randn(*shape).astype("float32"))


def foreach_cumsum(np_, npx_, rng):
    def fn(data, s0):
        return npx_.foreach(lambda x, st: (st[0] + x, [st[0] + x]), data,
                            [s0])

    return [_arr(np_, rng, 5, 3), _arr(np_, rng, 3)], [], fn


def foreach_square_states(np_, npx_, rng):
    def body(x, states):
        acc = states[0] + x * x
        return acc, [acc]

    return [_arr(np_, rng, 4, 1), _arr(np_, rng, 1)], [], \
        lambda d, s: npx_.foreach(body, d, [s])


def foreach_multi(np_, npx_, rng):
    """Two data arrays, two states, two outputs a step, a capture."""
    w = _arr(np_, rng, 3)

    def body(xs, states):
        a, b = xs
        s1, s2 = states
        h = np_.tanh(a * s1 + b * w)
        return [h, h * s2], [s1 + h, s2 * 0.9 + b]

    return [_arr(np_, rng, 4, 3), _arr(np_, rng, 4, 3), _arr(np_, rng, 3),
            _arr(np_, rng, 3)], [w], \
        lambda a, b, s1, s2: npx_.foreach(body, [a, b], [s1, s2])


def while_outputs(np_, npx_, rng):
    """The reference's test_while_loop_with_outputs with gradients: the
    step outputs padded to max_iterations, the captured scale none."""
    scale = _arr(np_, rng, 2)

    def fn(i, v):
        return npx_.while_loop(lambda i, v: i < 3,
                               lambda i, v: (v * scale, (i + 1, v * 1.5)),
                               (i, v), max_iterations=5)

    return [np_.array(onp.float32(1.0)), _arr(np_, rng, 2)], [scale], fn


def while_no_outputs(np_, npx_, rng):
    def fn(i, s):
        return npx_.while_loop(lambda i, s: i < 5,
                               lambda i, s: (None, (i + 1, s * 1.2 + i)),
                               (i, s), max_iterations=8)[1]

    return [np_.array(onp.float32(0.0)), _arr(np_, rng, 3)], [], fn


# without step outputs the reference lowers to lax.while_loop, which JAX
# cannot differentiate in reverse: values only
while_no_outputs.forward_only = True


def while_zero_steps(np_, npx_, rng):
    def fn(i, v):
        return npx_.while_loop(lambda i, v: i > 5,
                               lambda i, v: (v * 2, (i + 1, v + 1)),
                               (i, v), max_iterations=3)

    return [np_.array(onp.float32(0.0)), _arr(np_, rng, 2)], [], fn


def cond_true(np_, npx_, rng):
    w = _arr(np_, rng, 4)

    def fn(p, x):
        return npx_.cond(p, lambda a: (a * a * w).sum(), lambda a: a.sum(),
                         inputs=[x])

    return [np_.array(onp.float32(1.0)), _arr(np_, rng, 4)], [w], fn


def cond_false_two_outputs(np_, npx_, rng):
    def fn(p, x, y):
        return npx_.cond(p, lambda a, b: [a * b, a], lambda a, b: [a - b, b],
                         inputs=[x, y])

    return [np_.array(onp.float32(0.0)), _arr(np_, rng, 3),
            _arr(np_, rng, 3)], [], fn


CASES = [foreach_cumsum, foreach_square_states, foreach_multi,
         while_outputs, while_no_outputs, while_zero_steps, cond_true,
         cond_false_two_outputs]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_matches_reference(case):
    want = _run(case, _jax())
    got = _run(case, _torch())
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert _rel(g, w) <= RTOL, case.__name__
    for g, w in zip(got[2], want[2]):     # closure captures: no gradient
        assert not g.any() and not w.any(), case.__name__


def test_closure_capture_gets_no_gradient_where_a_loop_would():
    """The same body as a plain Python loop gives the captured weight a
    gradient; through foreach it gets none, in both packages."""
    for np_, npx_, ag in (_jax(), _torch()):
        w = np_.array(onp.full((2,), 0.5, "float32"))
        x = np_.array(onp.ones((3, 2), "float32"))
        w.attach_grad()
        x.attach_grad()
        with ag.record():
            outs, _ = npx_.foreach(lambda t, s: (t * w, s), x,
                                   [np_.zeros((2,))])
            outs.sum().backward()
        assert not w.grad.asnumpy().any()
        onp.testing.assert_allclose(x.grad.asnumpy(), 0.5)
    w = tnp.array(onp.full((2,), 0.5, "float32"))
    w.attach_grad()
    with tag.record():
        sum(x_t * w for x_t in tnp.ones((3, 2))).sum().backward()
    onp.testing.assert_allclose(w.grad.asnumpy(), 3.0)


def test_recorded_body_runs_once():
    """Under ``record()`` the body runs once a step: the backward reads the
    graph the forward recorded, and gives the reference's gradients."""
    calls = []

    def body(t, s):
        calls.append(1)
        return t * s[0], [s[0] + t]

    grads = []
    for np_, npx_, ag in (_jax(), _torch()):
        x = np_.array(onp.arange(1.0, 7.0, dtype="float32").reshape(3, 2))
        s0 = np_.array(onp.full((2,), 0.5, "float32"))
        x.attach_grad()
        s0.attach_grad()
        with ag.record():
            outs, st = npx_.foreach(body, x, [s0])
            loss = outs.sum() + st[0].sum()
        if np_ is tnp:
            calls.clear()
        loss.backward()
        grads.append([x.grad.asnumpy(), s0.grad.asnumpy()])
    assert not calls
    for g, w in zip(*grads[::-1]):
        assert _rel(g, w) <= RTOL


def test_reference_cases():
    """The reference's own assertions, on the port."""
    outs, final = tnpx.foreach(lambda x, s: (s[0] + x, [s[0] + x]),
                               tnp.array([[1.0], [2.0], [3.0]]),
                               [tnp.zeros((1,))])
    onp.testing.assert_allclose(outs.asnumpy(), [[1.0], [3.0], [6.0]])
    onp.testing.assert_allclose(final[0].asnumpy(), [6.0])
    _, (i_f, s_f) = tnpx.while_loop(lambda i, s: i < 5,
                                    lambda i, s: (None, (i + 1, s + i)),
                                    (tnp.array(0.0), tnp.array(0.0)))
    assert float(i_f) == 5 and float(s_f) == 10
    outs, (i_f,) = tnpx.while_loop(lambda i: i < 3,
                                   lambda i: (i * 2, (i + 1,)),
                                   (tnp.array(1.0),), max_iterations=5)
    assert float(i_f) == 3
    assert outs.asnumpy().tolist() == [2.0, 4.0, 0.0, 0.0, 0.0]
    x = tnp.array([1.0, 2.0])
    onp.testing.assert_allclose(tnpx.cond(tnp.array(True), lambda a: a * 2,
                                          lambda a: a * 3, [x]).asnumpy(),
                                [2.0, 4.0])
    onp.testing.assert_allclose(tnpx.cond(False, lambda: x * 2,
                                          lambda: x * 3).asnumpy(),
                                [3.0, 6.0])
    with pytest.raises(MXNetError, match="max_iterations"):
        tnpx.while_loop(lambda i: i < 3, lambda i: (i, (i + 1,)),
                        (tnp.array(0.0),))


def test_registered_ops_match_reference():
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.ops import apply_op as japply

    from mxnet_tpu_torch.ops import apply_op as tapply

    rng = onp.random.RandomState(3)
    data = rng.randn(4, 2).astype("float32")
    s0 = rng.randn(2).astype("float32")

    def body(x, states):
        return x * states[0], [states[0] + x]

    res = []
    for np_, apply in ((jnp_, japply), (tnp, tapply)):
        fe = apply("_foreach", np_.array(data), np_.array(s0), body=body,
                   num_states=1)
        wl = apply("_while_loop", np_.array(onp.float32(0.0)),
                   np_.array(s0), cond=lambda i, s: i < 3,
                   func=lambda i, s: (s, (i + 1, s * 2)), max_iterations=4)
        cd = apply("_cond", np_.array(onp.float32(1.0)), np_.array(s0),
                   then_func=lambda a: a + 1, else_func=lambda a: a - 1)
        res.append([o.asnumpy() for o in _flat([fe, wl, cd])])
    for g, w in zip(*res[::-1]):
        assert _rel(g, w) <= RTOL


class _TScan(THybridBlock):
    def forward(self, x):
        def body(t, states):
            return t * 2, [states[0] + t]

        outs, final = tnpx.foreach(body, x, [tnp.zeros(x.shape[1:])])
        return outs + final[0]


def test_foreach_inside_hybridize():
    """The reference's test_foreach_inside_hybridize on the port (on the CPU
    a hybridized block runs its body)."""
    net = _TScan()
    net.hybridize()
    out = net(tnp.array([[1.0], [2.0]]))
    onp.testing.assert_allclose(out.asnumpy(), [[5.0], [7.0]])


# -- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lstm_foreach(np_, npx_, rng, T=6, B=3, H=4, layers=2):
    """A stacked LSTM cell in mx.np through foreach: data (T, B, H), the
    initial h and c of each layer as states, the weights captured."""
    ws = [(np_.array((rng.randn(H, 4 * H) / 2).astype("float32")),
           np_.array((rng.randn(H, 4 * H) / 2).astype("float32")))
          for _ in range(layers)]

    def body(x, states):
        new = []
        for k, (wi, wh) in enumerate(ws):
            h, c = states[2 * k], states[2 * k + 1]
            g = np_.dot(x, wi) + np_.dot(h, wh)
            i, f, o, u = (g[:, j * H:(j + 1) * H] for j in range(4))
            c = npx_.sigmoid(f) * c + npx_.sigmoid(i) * np_.tanh(u)
            h = npx_.sigmoid(o) * np_.tanh(c)
            new += [h, c]
            x = h
        return x, new

    ops = [_arr(np_, rng, T, B, H)] + [_arr(np_, rng, B, H)
                                       for _ in range(2 * layers)]
    return ops, [w for pair in ws for w in pair], \
        lambda d, *s: npx_.foreach(body, d, list(s))


class _LSTMBlock(THybridBlock):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        outs, states = self._fn(*args)
        return [outs] + states


@pytest.mark.cuda
def test_foreach_lstm_on_card(cuda):
    """Eager and hybridized on the card against the CPU: outputs and the
    gradients into the data and the initial states."""
    want = _run(lstm_foreach, _torch())
    with tmx.gpu():
        got = _run(lstm_foreach, _torch())
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert _rel(g, w) <= 1e-5
    with tmx.gpu():
        rng = onp.random.RandomState(0)
        ops, _, fn = lstm_foreach(tnp, tnpx, rng)
        net = _LSTMBlock(fn)
        net.hybridize()
        for _ in range(3):
            outs = net(*ops)
        eager = _flat(fn(*ops))
        for g, w in zip(outs, eager):
            assert _rel(g.asnumpy(), w.asnumpy()) <= 1e-6


class _WhileBlock(THybridBlock):
    """A while loop in a hybridized block: with step outputs and
    ``max_iterations`` (the masked form under capture), or without either
    (which a capture cannot end)."""

    def __init__(self, bound):
        super().__init__()
        self._bound = bound

    def forward(self, i, v):
        if self._bound is None:
            return _flat(tnpx.while_loop(
                lambda i, v: i < 3, lambda i, v: (None, (i + 1, v + 1)),
                (i, v))[1])
        return _flat(tnpx.while_loop(lambda i, v: i < 3,
                                     lambda i, v: (v * 2, (i + 1, v + 1)),
                                     (i, v), max_iterations=self._bound))


class _CondBlock(THybridBlock):
    def forward(self, p, x):
        return tnpx.cond(p, lambda a: a * 2, lambda a: a - 1, [x])


@pytest.mark.cuda
def test_while_loop_and_cond_under_capture(cuda):
    with tmx.gpu():
        i, v = tnp.array(0.0), tnp.array([1.0, 2.0])
        net = _WhileBlock(5)
        net.hybridize()
        for _ in range(3):
            got = net(i, v)
        want = _flat(tnpx.while_loop(lambda i, v: i < 3,
                                     lambda i, v: (v * 2, (i + 1, v + 1)),
                                     (i, v), max_iterations=5))
        for g, w in zip(got, want):
            onp.testing.assert_allclose(g.asnumpy(), w.asnumpy())
        unbounded = _WhileBlock(None)
        unbounded.hybridize()
        with pytest.raises(MXNetError, match="CUDA graph capture"):
            for _ in range(2):
                unbounded(i, v)
        cnet = _CondBlock()
        cnet.hybridize()
        for p in (1.0, 0.0, 1.0):
            got = cnet(tnp.array(p), v)
            onp.testing.assert_allclose(got.asnumpy(), (v * 2 if p else
                                                        v - 1).asnumpy())
