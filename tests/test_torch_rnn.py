"""PyTorch/CUDA port: the ``rnn`` op and ``gluon.rnn`` (the fused layers and
the twelve cell classes), against the JAX package on the CPU.

The same seeded numpy inputs and weights go through ``mxnet_tpu`` and
``mxnet_tpu_torch``. Tolerances, each with its reason:

- outputs and final states within ``RTOL`` (1e-5) of the largest entry:
  the same step formulas in fp32, the products summed in another order
  (the port makes a sequence's input products in one matrix product and
  adds both biases there; the reference adds ``b_hh`` at each step);
- gradients of ``sum(out * c)`` (``c`` seeded, for every output) into
  ``x``, ``h0``, ``c0`` and each weight: JAX's ``vjp`` against torch's
  autograd, within ``GRAD_RTOL`` (1e-5) of each gradient's largest entry;
- under ``amp.autocast("bfloat16")`` (``rnn`` is an MXU op: its float32
  operands are cast at entry) within ``BF16_RTOL`` (2^-6) of the largest
  entry: a T-step bf16 recurrence whose rounding compounds step by step.

Weights move between the packages through ``.params`` files, which both
read. The dropout cells run at rate 0, or in predict mode, where the two
packages' random streams cannot match. The ``cuda`` tests hold the card to
the CPU on the same inputs (outputs at ``RTOL``, gradients within
``CARD_GRAD_RTOL``, 1e-4). The JAX package is imported inside the tests that
use it, so ``pytest --noconftest tests/test_torch_rnn.py -m cuda`` collects
this file on a machine without JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import registry as treg

RTOL = 1e-5
GRAD_RTOL = 1e-5
CARD_GRAD_RTOL = 1e-4
BF16_RTOL = 2.0 ** -6
T, B, I, H = 5, 3, 4, 6
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


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


def _op_inputs(mode, layers, ndir, seed):
    """x, h0[, c0] and the flat weights of one case, from ``seed``."""
    rng = onp.random.RandomState(seed)
    ng = GATES[mode]
    ins = [rng.randn(T, B, I).astype("float32"),
           (0.5 * rng.randn(layers * ndir, B, H)).astype("float32")]
    if mode == "lstm":
        ins.append((0.5 * rng.randn(layers * ndir, B, H)).astype("float32"))
    for layer in range(layers):
        n_in = I if layer == 0 else H * ndir
        for _ in range(ndir):
            ins += [(rng.randn(ng * H, n_in) / onp.sqrt(n_in)).astype(
                        "float32"),
                    (rng.randn(ng * H, H) / onp.sqrt(H)).astype("float32"),
                    (0.1 * rng.randn(ng * H)).astype("float32"),
                    (0.1 * rng.randn(ng * H)).astype("float32")]
    return ins


def _attrs(mode, layers, ndir):
    return dict(mode=mode, num_layers=layers, hidden_size=H,
                bidirectional=ndir == 2, dropout=0.0)


def _port_op(ins, attrs, cots, device="cpu"):
    """The port's op on ``ins``: outputs and the gradients of
    ``sum(out * cot)`` into every input."""
    ts = [torch.tensor(a, device=device, requires_grad=True) for a in ins]
    outs = treg.get_op("rnn").fn(**attrs)(*ts)
    grads = torch.autograd.grad(
        outs, ts, [torch.tensor(c, device=device) for c in cots])
    return ([o.detach().cpu().numpy() for o in outs],
            [g.cpu().numpy() for g in grads])


CASES = [(mode, layers, ndir) for mode in GATES for layers in (1, 2)
         for ndir in (1, 2)]


@pytest.mark.parametrize("mode,layers,ndir", CASES,
                         ids=[f"{m}-{n}layer-{'bi' if d == 2 else 'uni'}"
                              for m, n, d in CASES])
def test_rnn_op_matches_reference(mode, layers, ndir):
    """Each mode, one and two layers, one and two directions: outputs,
    final states and every gradient against ``jax.vjp`` of the
    reference's op."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    ins = _op_inputs(mode, layers, ndir, seed=len(mode) * 10 + layers + ndir)
    attrs = _attrs(mode, layers, ndir)
    jouts, vjp = jax.vjp(jreg.get_op("rnn").fn(**attrs),
                         *[jnp.asarray(a) for a in ins])
    assert len(jouts) == (3 if mode == "lstm" else 2)
    rng = onp.random.RandomState(5)
    cots = [rng.randn(*o.shape).astype("float32") for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    touts, tgrads = _port_op(ins, attrs, cots)
    assert len(touts) == len(jouts)
    for got, want in zip(touts, jouts):
        assert _rel(got, onp.asarray(want)) <= RTOL
    for k, (got, want) in enumerate(zip(tgrads, jgrads)):
        assert _rel(got, onp.asarray(want)) <= GRAD_RTOL, k


def test_reverse_direction_writes_each_step_back():
    """The reverse direction's output at step t belongs to x[t]: it equals
    a forward-only run over the flipped sequence, flipped back, on an
    asymmetric input (T = 5)."""
    ins = _op_inputs("gru", 1, 2, seed=3)
    x, h0, w = ins[0], ins[1], ins[2:]
    f = treg.get_op("rnn").fn(**_attrs("gru", 1, 2))
    out, h = f(*[torch.tensor(a) for a in ins])
    g = treg.get_op("rnn").fn(**_attrs("gru", 1, 1))
    rev, h_rev = g(torch.tensor(x[::-1].copy()), torch.tensor(h0[1:]),
                   *[torch.tensor(a) for a in w[4:]])
    onp.testing.assert_array_equal(out[:, :, H:].numpy(),
                                   rev.flip(0).numpy())
    onp.testing.assert_array_equal(h[1].numpy(), h_rev[0].numpy())
    assert not torch.equal(out[0, :, H:], out[-1, :, H:])


def test_rnn_op_ignores_dropout_and_checks_operands():
    """``dropout`` is ignored, as the reference's (no dropout between
    layers); a wrong number of weight arrays raises."""
    ins = [torch.tensor(a) for a in _op_inputs("lstm", 2, 1, seed=4)]
    a = treg.get_op("rnn").fn(**_attrs("lstm", 2, 1))(*ins)
    with tag.record():
        b = treg.get_op("rnn").fn(**{**_attrs("lstm", 2, 1),
                                     "dropout": 0.5})(*ins)
    for u, v in zip(a, b):
        onp.testing.assert_array_equal(u.numpy(), v.detach().numpy())
    with pytest.raises(MXNetError, match="weight arrays"):
        treg.get_op("rnn").fn(**_attrs("lstm", 2, 1))(*ins[:-1])


def test_rnn_reaches_the_registry_names():
    """``npx.rnn``, ``mx.nd.RNN`` and ``RNN`` in the registry are the one
    op; ``mx.sym.RNN`` makes three outputs for LSTM and two otherwise, and
    its graph runs."""
    from mxnet_tpu_torch import nd as tnd
    from mxnet_tpu_torch import npx as tnpx
    from mxnet_tpu_torch import symbol as tsym

    assert treg.get_op("RNN") is treg.get_op("rnn")
    ins = _op_inputs("lstm", 1, 1, seed=6)
    attrs = _attrs("lstm", 1, 1)
    want = treg.get_op("rnn").fn(**attrs)(*[torch.tensor(a) for a in ins])
    for fn in (tnpx.rnn, tnd.RNN):
        got = fn(*[tnp.array(a) for a in ins], **attrs)
        assert len(got) == 3
        for g, w in zip(got, want):
            onp.testing.assert_array_equal(g.asnumpy(), w.numpy())
    names = ["x", "h", "c"] + [f"w{i}" for i in range(4)]
    s = tsym.RNN(*[tsym.var(n) for n in names], **attrs)
    assert len(s) == 3
    got = s.eval(**{n: tnp.array(a) for n, a in zip(names, ins)})
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g.asnumpy(), w.numpy())
    gru = tsym.RNN(*[tsym.var(n) for n in ("x", "h", "w0", "w1", "w2",
                                             "w3")], **_attrs("gru", 1, 1))
    assert len(gru) == 2
    assert len(tsym.fromjson(s.tojson())) == 3


# -- the layers ---------------------------------------------------------------
LAYERS = [("LSTM", "TNC", True), ("LSTM", "NTC", False),
          ("GRU", "NTC", True), ("GRU", "TNC", False),
          ("RNN", "TNC", True), ("RNN", "NTC", False)]


def _layer(rnn, cls, layout, **kw):
    extra = {"activation": "tanh"} if cls == "RNN" else {}
    return getattr(rnn, cls)(H, num_layers=2, layout=layout,
                             bidirectional=True, **extra, **kw)


@pytest.mark.parametrize("cls,layout,with_states", LAYERS,
                         ids=[f"{c}-{lay}-{'states' if s else 'nostates'}"
                              for c, lay, s in LAYERS])
def test_layer_loads_reference_params(tmp_path, cls, layout, with_states):
    """A two-layer bidirectional layer of the reference, deferred input
    size finished by its forward and saved; the port's layer (deferred too)
    loads the file and gives the same outputs and states, in both layouts,
    with and without states; the port's file loads back into the
    reference."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import rnn as jrnn

    rng = onp.random.RandomState(7)
    shape = (T, B, I) if layout == "TNC" else (B, T, I)
    x = rng.randn(*shape).astype("float32")
    ns = 2 if cls == "LSTM" else 1
    states = [(0.5 * rng.randn(4, B, H)).astype("float32")
              for _ in range(ns)]
    mx.random.seed(3)
    jl = _layer(jrnn, cls, layout)
    jl.initialize(mx.initializer.Uniform(0.3))
    args = [jnp_.array(x)] + ([[jnp_.array(s) for s in states]]
                              if with_states else [])
    jout = jl(*args)
    jl.save_parameters(str(tmp_path / "ref.params"))
    tl = _layer(trnn, cls, layout)
    assert tl.l0_i2h_weight.is_deferred
    tl.load_parameters(str(tmp_path / "ref.params"))
    assert list(tl.collect_params()) == list(jl.collect_params())
    targs = [tnp.array(x)] + ([[tnp.array(s) for s in states]]
                              if with_states else [])
    tout = tl(*targs)
    if with_states:
        assert isinstance(tout[1], list) and len(tout[1]) == ns
        assert _rel(tout[0].asnumpy(), jout[0].asnumpy()) <= RTOL
        for g, w in zip(tout[1], jout[1]):
            assert g.shape == w.shape == (4, B, H)
            assert _rel(g.asnumpy(), w.asnumpy()) <= RTOL
    else:
        assert _rel(tout.asnumpy(), jout.asnumpy()) <= RTOL
    tl.save_parameters(str(tmp_path / "port.params"))
    jl2 = _layer(jrnn, cls, layout, input_size=I)
    jl2.load_parameters(str(tmp_path / "port.params"))
    again = jl2(*args)
    again = again[0] if with_states else again
    want = jout[0] if with_states else jout
    onp.testing.assert_array_equal(again.asnumpy(), want.asnumpy())


def test_layer_deferred_input_size_begin_state_and_hybridize():
    """Layer 0's ``i2h_weight`` waits for the first input (both
    directions); ``begin_state`` makes NDArray zeros on the layer's device;
    a hybridized call fills the placeholders first and equals eager."""
    lay = trnn.LSTM(H, num_layers=2, bidirectional=True, layout="NTC")
    lay.initialize()
    assert lay.l0_i2h_weight.shape == (4 * H, 0)
    assert lay.l1_i2h_weight.shape == (4 * H, 2 * H)
    st = lay.begin_state(B)
    assert [s.shape for s in st] == [(4, B, H)] * 2
    assert all(isinstance(s, tmx.NDArray) and s._data.device.type == "cpu"
               and not s.asnumpy().any() for s in st)
    assert [i["shape"] for i in lay.state_info(B)] == [(4, B, H)] * 2
    x = tnp.array(onp.random.RandomState(1).randn(B, T, I).astype("float32"))
    eager, eager_st = lay(x, st)
    assert lay.l0_i2h_weight.shape == lay.l0_r_i2h_weight.shape == (4 * H, I)
    lay2 = trnn.LSTM(H, num_layers=2, bidirectional=True, layout="NTC")
    lay2.initialize()
    lay2.hybridize()
    lay2.load_dict({n: p.detach() for n, p in lay.collect_params().items()})
    hyb, hyb_st = lay2(x, st)
    onp.testing.assert_array_equal(hyb.asnumpy(), eager.asnumpy())
    for a, b in zip(hyb_st, eager_st):
        onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert repr(lay) == "LSTM(6, layers=2, layout=NTC)"
    with pytest.raises(MXNetError, match="invalid layout"):
        trnn.GRU(H, layout="NCT")


def test_lstm_under_amp_matches_reference():
    """One ``amp.autocast("bfloat16")`` forward of a two-layer LSTM layer
    against the reference's under its ``amp``: bf16 outputs and states."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import rnn as jrnn

    from mxnet_tpu_torch import amp as tamp

    rng = onp.random.RandomState(8)
    x = rng.randn(T, B, I).astype("float32")
    states = [(0.5 * rng.randn(2, B, H)).astype("float32")
              for _ in range(2)]
    mx.random.seed(4)
    jl = jrnn.LSTM(H, num_layers=2, input_size=I)
    jl.initialize(mx.initializer.Uniform(0.3))
    tl = trnn.LSTM(H, num_layers=2, input_size=I)
    tl.load_dict({n: p.data().asnumpy()
                  for n, p in jl.collect_params().items()})
    with jamp.autocast("bfloat16"):
        jout, jst = jl(jnp_.array(x), [jnp_.array(s) for s in states])
    with tamp.autocast("bfloat16"):
        tout, tst = tl(tnp.array(x), [tnp.array(s) for s in states])
    for got, want in zip([tout, *tst], [jout, *jst]):
        assert str(got.dtype) == str(want.dtype) == "bfloat16"
        assert _rel(got.astype("float32").asnumpy(),
                    want.astype("float32").asnumpy()) <= BF16_RTOL


# -- the cells ----------------------------------------------------------------
CELLS = ["RNNCell", "LSTMCell", "GRUCell", "LSTMPCell", "SequentialRNNCell",
         "HybridSequentialRNNCell", "DropoutCell", "ZoneoutCell",
         "ResidualCell", "BidirectionalCell", "VariationalDropoutCell"]


def _cell(rnn, name):
    if name == "RNNCell":
        return rnn.RNNCell(H, activation="relu")
    if name == "LSTMCell":
        return rnn.LSTMCell(H)
    if name == "GRUCell":
        return rnn.GRUCell(H)
    if name == "LSTMPCell":
        return rnn.LSTMPCell(H, 3)
    if name in ("SequentialRNNCell", "HybridSequentialRNNCell"):
        cell = getattr(rnn, name)()
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.GRUCell(H))
        return cell
    if name == "DropoutCell":
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.LSTMCell(H))
        cell.add(rnn.DropoutCell(0.5))
        return cell
    if name == "ZoneoutCell":
        return rnn.ZoneoutCell(rnn.LSTMCell(H), 0.5, 0.5)
    if name == "ResidualCell":
        return rnn.ResidualCell(rnn.GRUCell(I))
    if name == "BidirectionalCell":
        return rnn.BidirectionalCell(rnn.LSTMCell(H), rnn.GRUCell(H))
    return rnn.VariationalDropoutCell(rnn.LSTMCell(H), 0.5, 0.5, 0.5)


def _outs(x):
    if isinstance(x, (list, tuple)):
        return [o for v in x for o in _outs(v)]
    return [x.asnumpy()]


@pytest.mark.parametrize("name", CELLS)
def test_cell_matches_reference(tmp_path, name):
    """Each cell of the reference, its deferred input size finished by an
    unroll and its weights saved, against the port's cell loading the file:
    one step (not for ``BidirectionalCell``, which raises in both), and
    ``unroll`` with ``merge_outputs`` True (NTC, with ``valid_length``) and
    False (TNC), outputs and states; the dropout cells in predict mode."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import rnn as jrnn

    rng = onp.random.RandomState(len(name))
    x_ntc = rng.randn(B, 4, I).astype("float32")
    x_tnc = x_ntc.transpose(1, 0, 2).copy()
    valid = onp.array([2, 4, 3], "int32")
    mx.random.seed(5)
    jc = _cell(jrnn, name)
    jc.initialize(mx.initializer.Uniform(0.4))
    jc.unroll(4, jnp_.array(x_ntc))         # finish deferred shapes
    jc.save_parameters(str(tmp_path / "cell.params"))
    tc = _cell(trnn, name)
    tc.load_parameters(str(tmp_path / "cell.params"))
    assert list(tc.collect_params()) == list(jc.collect_params())
    jst = jc.begin_state(B)
    tst = tc.begin_state(B)
    assert [s.shape for s in tst] == [s.shape for s in jst]
    if name == "BidirectionalCell":
        for c, st, np_, err in ((jc, jst, jnp_, mx.base.MXNetError),
                                (tc, tst, tnp, MXNetError)):
            with pytest.raises(err, match="unroll"):
                c(np_.array(x_ntc[:, 0]), st)
    else:
        want = jc(jnp_.array(x_ntc[:, 0]), jst)
        got = tc(tnp.array(x_ntc[:, 0]), tst)
        for g, w in zip(_outs(got), _outs(want)):
            assert _rel(g, w) <= RTOL
    want = jc.unroll(4, jnp_.array(x_ntc), layout="NTC", merge_outputs=True,
                     valid_length=jnp_.array(valid))
    got = tc.unroll(4, tnp.array(x_ntc), layout="NTC", merge_outputs=True,
                    valid_length=tnp.array(valid))
    assert got[0].shape == want[0].shape
    for g, w in zip(_outs(got), _outs(want)):
        assert _rel(g, w) <= RTOL
    # steps at and past a row's length are zeros (a bidirectional cell's
    # right half: the whole padded sequence flipped, as the reference's)
    cols = slice(0, H) if name == "BidirectionalCell" else slice(None)
    assert not got[0].asnumpy()[0, 2:, cols].any()
    want = jc.unroll(4, jnp_.array(x_tnc), layout="TNC", merge_outputs=False)
    got = tc.unroll(4, tnp.array(x_tnc), layout="TNC", merge_outputs=False)
    if name != "BidirectionalCell":     # which merges always, as there
        assert isinstance(got[0], list) and len(got[0]) == 4
    for g, w in zip(_outs(got), _outs(want)):
        assert _rel(g, w) <= RTOL


def test_recurrent_cell_base_and_exports():
    """``gluon.rnn`` exports the reference's fifteen names; the base cell
    has no ``state_info``, as the reference's."""
    from mxnet_tpu.gluon import rnn as jrnn

    assert trnn.__all__ == jrnn.__all__ and len(trnn.__all__) == 15
    assert trnn.HybridSequentialRNNCell is trnn.SequentialRNNCell
    for rnn in (jrnn, trnn):
        with pytest.raises(NotImplementedError):
            rnn.RecurrentCell().begin_state(2)


def test_dropout_cells_at_rate_zero_under_record():
    """Under ``record()`` at rate 0 the dropout cells are their base cells,
    in both packages; the gradients of the port's unroll reach the
    weights."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon import rnn as jrnn

    x = onp.random.RandomState(2).randn(B, 3, I).astype("float32")
    outs = []
    for rnn, np_, ag, seed in ((jrnn, jnp_, jag, mx.random.seed),
                               (trnn, tnp, tag, tmx.random.seed)):
        seed(6)
        cell = rnn.SequentialRNNCell()
        cell.add(rnn.VariationalDropoutCell(rnn.LSTMCell(H, input_size=I),
                                            0.0, 0.0, 0.0))
        cell.add(rnn.DropoutCell(0.0))
        cell.add(rnn.ZoneoutCell(rnn.GRUCell(H, input_size=H), 0.0, 0.0))
        cell.initialize()
        with ag.record():
            out, st = cell.unroll(3, np_.array(x), merge_outputs=True)
        outs.append((cell, out))
    (jc, jout), (tc, tout) = outs
    tc.load_dict({n: p.data().asnumpy()
                  for n, p in jc.collect_params().items()})
    with tag.record():
        tout, _ = tc.unroll(3, tnp.array(x), merge_outputs=True)
        loss = tout.sum()
    loss.backward()
    assert _rel(tout.asnumpy(), jout.asnumpy()) <= RTOL
    first = next(iter(tc.children()))
    assert float(abs(first.base_cell.i2h_weight.grad).sum()) > 0


def test_variational_masks_last_a_sequence():
    """The port's ``VariationalDropoutCell``: under ``record()`` one mask a
    sequence, reused at every step and drawn anew by the next ``unroll``;
    hybridized (or inside a hybridized container) its steps run eagerly, as
    the reference's cell called with a list of states; a step inside
    another block's program raises."""
    cell = trnn.VariationalDropoutCell(trnn.ResidualCell(
        trnn.DropoutCell(0.0)), drop_inputs=0.5)
    cell.initialize()
    x = tnp.ones((B, 6, I))
    with tag.record():
        a, _ = cell.unroll(6, x, merge_outputs=True)
        mask_a = cell._mask_i
        b, _ = cell.unroll(6, x, merge_outputs=True)
    a, b = a.asnumpy(), b.asnumpy()
    for t in range(6):      # x + x * mask: the same pattern every step
        onp.testing.assert_array_equal(a[:, t], a[:, 0])
    assert not onp.array_equal(a[:, 0], b[:, 0])
    assert cell._mask_i is not mask_a
    seq = trnn.SequentialRNNCell()
    seq.add(trnn.LSTMCell(H, input_size=I))
    seq.add(cell)
    seq.initialize()
    seq.hybridize()
    assert not seq._active and not cell._active

    class Wrap(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.cell = trnn.VariationalDropoutCell(
                trnn.LSTMCell(H, input_size=I), drop_inputs=0.5)

        def forward(self, x, h, c):
            return self.cell(x, [h, c])[0]

    net = Wrap()
    net.initialize()
    net.hybridize()
    z = tnp.zeros((B, H))
    with tag.record(), pytest.raises(MXNetError, match="Variational"):
        net(tnp.ones((B, I)), z, z)


def test_gru_cell_agrees_with_the_gru_op():
    """The GRU cell's reset gate multiplies the hidden product with its
    bias, as the op does: a cell unrolled over T steps equals a one-layer
    ``GRU`` layer holding the same weights."""
    cell = trnn.GRUCell(H, input_size=I)
    cell.initialize(tmx.initializer.Uniform(0.5), seed=3)
    with torch.no_grad():
        cell.h2h_bias.copy_(torch.linspace(-1, 1, 3 * H))
    lay = trnn.GRU(H, input_size=I)
    lay.load_dict({f"l0_{n}": p.detach()
                   for n, p in cell.collect_params().items()})
    x = tnp.array(onp.random.RandomState(9).randn(T, B, I).astype("float32"))
    h0 = tnp.array((0.5 * onp.random.RandomState(10).randn(B, H)).astype(
        "float32"))
    want, wst = cell.unroll(T, x, [h0], layout="TNC", merge_outputs=True)
    got, gst = lay(x, [h0.reshape(1, B, H)])
    assert _rel(got.asnumpy(), want.asnumpy()) <= RTOL
    assert _rel(gst[0].asnumpy()[0], wst[0].asnumpy()) <= RTOL


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, with TF32 off for the test, so fp32 products sum in fp32
    as the CPU does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("mode,layers,ndir", CASES,
                         ids=[f"{m}-{n}layer-{'bi' if d == 2 else 'uni'}"
                              for m, n, d in CASES])
def test_rnn_op_on_card(cuda, mode, layers, ndir):
    """The op on the card against the CPU: outputs, states and every
    gradient."""
    ins = _op_inputs(mode, layers, ndir, seed=layers + ndir)
    attrs = _attrs(mode, layers, ndir)
    n_out = 3 if mode == "lstm" else 2
    rng = onp.random.RandomState(5)
    shapes = [(T, B, H * ndir)] + [(layers * ndir, B, H)] * (n_out - 1)
    cots = [rng.randn(*s).astype("float32") for s in shapes]
    want, want_g = _port_op(ins, attrs, cots)
    got, got_g = _port_op(ins, attrs, cots, device="cuda")
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) <= CARD_GRAD_RTOL


@pytest.mark.cuda
def test_layer_state_on_other_device_raises(cuda):
    """A CPU state fed to a card forward raises, rather than being
    copied."""
    lay = trnn.LSTM(H, input_size=I, device="cuda")
    lay.initialize()
    x = torch.randn(T, B, I, device="cuda")
    with pytest.raises(MXNetError, match="lies on"):
        lay(x, [torch.zeros(1, B, H), torch.zeros(1, B, H)])
    st = lay.begin_state(B)
    assert all(s._data.device.type == "cuda" for s in st)
