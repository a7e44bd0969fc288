"""PyTorch/CUDA port: ``model_zoo.RNNModel`` (the reference's word_lm LSTM
language model) and ``tests/torch_script_word_lm.py``, against the JAX
package on the CPU.

Weights come from the reference's saved ``.params`` at ``dropout=0``.
Logits, states and the weights after one ``adam`` step with
``clip_gradient`` are held within ``RTOL`` (1e-5) of each tensor's largest
entry (the same fp32 formulas; the LSTM's products summed in another
order). A graph the JAX package exports runs in the port through
``SymbolBlock.imports``, and the port's own export with states (a
three-output ``rnn`` node) runs back in the port. The ``cuda`` test holds
the card's logits, states and gradients to the CPU's (gradients within
``CARD_GRAD_RTOL``, 1e-4).
"""
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import RNNModel

RTOL = 1e-5
CARD_GRAD_RTOL = 1e-4
VOCAB, N, T = 50, 3, 6


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


def _tokens(seed):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, VOCAB, (N, T)).astype("int32"),
            rng.randint(0, VOCAB, (N, T)).astype("int32"))


def _cfg(tied):
    return dict(vocab_size=VOCAB, embed_size=8, hidden_size=8 if tied else 6,
                num_layers=2, dropout=0.0, tie_weights=True)


def _reference_model(tmp_path, tied, toks):
    """The reference's RNNModel, initialized, its deferred shapes finished
    by a forward, saved; returns (model, params file)."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon.model_zoo import RNNModel as JRNNModel

    mx.random.seed(2)
    jm = JRNNModel(**_cfg(tied))
    jm.initialize(mx.initializer.Xavier())
    jm(jnp_.array(toks))
    path = str(tmp_path / "lm.params")
    jm.save_parameters(path)
    return jm, path


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_rnn_model_adam_step_matches_reference(tmp_path, tied):
    """Stateful logits and states, then one word_lm step (``adam``,
    ``clip_gradient`` 0.25, states detached, mean cross entropy) from the
    reference's saved weights: logits, states and every updated weight."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import np as jnp_

    toks, target = _tokens(1)
    jm, path = _reference_model(tmp_path, tied, toks)
    tm = RNNModel(**_cfg(tied))
    tm.load_parameters(path)
    assert list(tm.collect_params()) == list(jm.collect_params())
    assert hasattr(tm, "decoder") == (not tied)
    results = []
    for m, np_, ag, gl in ((jm, jnp_, jag, jgluon),
                           (tm, tnp, tag, tgluon)):
        trainer = gl.Trainer(m.collect_params(), "adam",
                             {"learning_rate": 1e-2, "clip_gradient": 0.25})
        loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
        rs = onp.random.RandomState(3)
        states = [np_.array((0.3 * rs.randn(2, N, m.hidden_size)).astype(
            "float32")) for _ in range(2)]
        states = [s.detach() for s in states]
        with ag.record():
            logits, new_states = m(np_.array(toks), states)
            loss = loss_fn(logits, np_.array(target)).mean()
        loss.backward()
        trainer.step(1)
        results.append((logits.asnumpy(), [s.asnumpy() for s in new_states],
                        {n: p.data().asnumpy()
                         for n, p in m.collect_params().items()}))
    (jl, js, jw), (tl, ts, tw) = results
    assert tl.shape == (N, T, VOCAB)
    assert _rel(tl, jl) <= RTOL
    for g, w in zip(ts, js):
        assert _rel(g, w) <= RTOL
    for name in jw:
        assert _rel(tw[name], jw[name]) <= RTOL, name
    assert isinstance(tgluon.model_zoo.rnn_lm.rnn_lm(**_cfg(tied)), RNNModel)


def test_rnn_model_hybridized_nested_outputs_and_stateless():
    """A hybridized ``RNNModel`` returns ``(logits, [h, c])`` as eager does,
    under ``record()`` too, and its gradients match eager's; without states
    it returns the logits only; ``begin_state`` is two NDArray zeros."""
    toks, target = _tokens(4)
    tmx.random.seed(1)
    eager = RNNModel(**_cfg(True))
    eager.initialize(tmx.initializer.Xavier(), seed=5)
    eager(tnp.array(toks))
    hyb = RNNModel(**_cfg(True))
    hyb.load_dict({n: p.detach() for n, p in eager.collect_params().items()})
    hyb.hybridize()
    st = eager.begin_state(N)
    assert len(st) == 2 and all(isinstance(s, tmx.NDArray) for s in st)
    outs = []
    for m in (eager, hyb):
        with tag.record():
            logits, new = m(tnp.array(toks), st)
            loss = tgluon.loss.SoftmaxCrossEntropyLoss()(
                logits, tnp.array(target)).mean()
        loss.backward()
        assert isinstance(new, list) and len(new) == 2
        outs.append((logits.asnumpy(), [s.asnumpy() for s in new],
                     m.embedding.weight.grad.numpy().copy()))
    (el, es, eg), (hl, hs, hg) = outs
    onp.testing.assert_allclose(hl, el, rtol=0, atol=1e-6)
    for a, b in zip(hs, es):
        onp.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert _rel(hg, eg) <= RTOL
    only = hyb(tnp.array(toks))
    assert isinstance(only, tmx.NDArray) and only.shape == (N, T, VOCAB)


def test_reference_export_runs_in_the_port(tmp_path):
    """The JAX package hybridizes and exports a stateless ``RNNModel``
    (embedding, ``swapaxes``, the ``rnn`` node, the tied matmul); the
    port's ``SymbolBlock.imports`` runs the graph with its ``.params`` and
    gives the reference's logits."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as jnp_
    from mxnet_tpu.gluon.model_zoo import RNNModel as JRNNModel

    toks, _ = _tokens(5)
    mx.random.seed(3)
    jm = JRNNModel(**_cfg(True))
    jm.initialize(mx.initializer.Xavier())
    jm.hybridize()
    want = jm(jnp_.array(toks)).asnumpy()
    sym_file, param_file = jm.export(str(tmp_path / "lm"))
    blk = tgluon.SymbolBlock.imports(sym_file, ["data0"], param_file,
                                     ctx=tmx.cpu())
    got = blk(tnp.array(toks)).asnumpy()
    assert _rel(got, want) <= RTOL


def test_port_export_with_states_round_trips(tmp_path):
    """The port exports a stateful ``RNNModel``: the graph's ``rnn`` node
    gives three outputs (LSTM), the heads are the logits and both states,
    and the imported block gives what the model gives."""
    import json

    toks, _ = _tokens(6)
    m = RNNModel(**_cfg(False))
    m.initialize(tmx.initializer.Xavier(), seed=2)
    m.hybridize()
    st = [tnp.array((0.2 * onp.random.RandomState(k).randn(2, N, 6)).astype(
        "float32")) for k in range(2)]
    logits, new = m(tnp.array(toks), st)
    sym_file, param_file = m.export(str(tmp_path / "port_lm"))
    graph = json.load(open(sym_file))
    rnn_nodes = [i for i, n in enumerate(graph["nodes"]) if n["op"] == "rnn"]
    assert len(rnn_nodes) == 1
    assert sorted(j for i, j in graph["heads"] if i == rnn_nodes[0]) == [1, 2]
    blk = tgluon.SymbolBlock.imports(sym_file, ["data0", "data1", "data2"],
                                     param_file, ctx=tmx.cpu())
    got = blk(tnp.array(toks), *st)
    for g, w in zip(got, [logits, *new]):
        onp.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=0,
                                    atol=1e-6)


def _word_lm():
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_script_word_lm

    return torch_script_word_lm


def test_word_lm_script_trains_and_refuses_onnx():
    """``tests/torch_script_word_lm.py`` (the reference's example, imports
    changed) trains at a tiny width on the CPU: one epoch's loss is finite
    and the second's lower; ``--export-onnx`` raises naming ROADMAP A10."""
    wl = _word_lm()
    tmx.random.seed(0)
    epochs = wl.main(["--batch-size", "400", "--hidden", "16", "--layers",
                      "1", "--epochs", "2", "--bptt", "20", "--lr", "1e-2"])
    assert len(epochs) == 2 and all(onp.isfinite(e[0]) for e in epochs)
    assert epochs[1][0] < epochs[0][0]
    assert abs(epochs[0][1] - onp.exp(epochs[0][0])) < 1e-6 * epochs[0][1]
    with pytest.raises(MXNetError, match="A10"):
        wl.main(["--epochs", "0", "--hidden", "8", "--export-onnx",
                 "lm.onnx"])


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hyb"])
def test_rnn_model_on_card(cuda, hybridize):
    """``RNNModel`` on the card against the same weights on the CPU:
    logits, states and every gradient of one stateful step, eager and
    hybridized (one CUDA graph forward, one backward)."""
    toks, target = _tokens(7)
    cpu = RNNModel(**_cfg(True))
    cpu.initialize(tmx.initializer.Xavier(), seed=3)
    cpu(tnp.array(toks))
    with tmx.gpu():
        card = RNNModel(**_cfg(True))
        card.load_dict({n: p.detach()
                        for n, p in cpu.collect_params().items()})
        if hybridize:
            card.hybridize()
    outs = []
    for m, ctx in ((cpu, tmx.cpu()), (card, tmx.gpu())):
        with ctx:
            st = m.begin_state(N)
            with tag.record():
                logits, new = m(tnp.array(toks), st)
                loss = tgluon.loss.SoftmaxCrossEntropyLoss()(
                    logits, tnp.array(target)).mean()
            loss.backward()
            outs.append((logits.asnumpy(), [s.asnumpy() for s in new],
                         {n: p.grad.cpu().numpy()
                          for n, p in m.collect_params().items()}))
    (cl, cs, cg), (gl, gs, gg) = outs
    assert _rel(gl, cl) <= RTOL
    for a, b in zip(gs, cs):
        assert _rel(a, b) <= RTOL
    for name in cg:
        assert _rel(gg[name], cg[name]) <= CARD_GRAD_RTOL, name
