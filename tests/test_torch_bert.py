"""PyTorch/CUDA port: the BERT model family against the JAX package, on the
CPU.

Tiny BERT (2 layers, 64 units, 4 heads, hidden 128, vocab 100, max_length
32, dropout 0) holds the JAX package's weights: numpy draws set into the
reference's ``BERTForPretraining``, saved with ``save_parameters`` and
loaded by the port's ``load_parameters`` (the parameter names are the
reference's). Checked: the names, ``BERTModel`` with and without
``token_types``/``valid_length`` (a row of valid length 0 included: every
key masked, the flash kernel's zeros), ``BERTForPretraining``'s two
outputs, and the pretraining loss's gradients of every parameter, the
word embedding's (the tied MLM decoder and the embedding lookup) among
them. Tolerance: 1e-5 of each tensor's largest entry, the predict-mode
bound of ``tests/test_torch_resnet.py`` (fp32 sums in another order).
The reference runs hybridized, one program a signature; its attention
reaches the Pallas flash kernel through the JAX package's own CPU path.

The JAX package is imported inside the fixtures, so ``pytest --noconftest
tests/test_torch_bert.py -m cuda`` collects this file on a machine without
JAX.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import (BERTForPretraining, BERTModel,
                                             bert_base)
from mxnet_tpu_torch.ops import cuda_kernels as ck

RTOL = 1e-5
VOCAB = 100
CFG = dict(vocab_size=VOCAB, num_layers=2, units=64, hidden_size=128,
           num_heads=4, max_length=32, dropout=0.0)
B, T = 3, 16


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rel(got, want):
    got = onp.asarray(got, dtype="float64")
    want = onp.asarray(want, dtype="float64")
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _inputs():
    rs = onp.random.RandomState(1)
    tok = rs.randint(0, VOCAB, (B, T)).astype("int32")
    tt = rs.randint(0, 2, (B, T)).astype("int32")
    vl = onp.array([T, 5, 0], "float32")
    labels = rs.randint(0, VOCAB, (B, T)).astype("float32")
    nsp = onp.array([0, 1, 1], "float32")
    return tok, tt, vl, labels, nsp


def _weights(shapes, seed=0):
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            a = 0.1 * rs.randn(*shape)
        elif "embed" in name:
            a = 0.5 * rs.randn(*shape)
        else:
            a = rs.randn(*shape) / onp.sqrt(shape[-1])
        out[name] = a.astype("float32")
    return out


def _port_model(path):
    bert = BERTModel(**CFG, device="cpu")
    model = BERTForPretraining(bert, vocab_size=VOCAB)
    model.load_parameters(str(path))
    return model


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's weights file and its results: ``BERTModel`` without
    and with token types and valid lengths, ``BERTForPretraining``'s
    outputs, and the pretraining loss's gradients."""
    import mxnet_tpu as mx
    from mxnet_tpu import np as mnp
    from mxnet_tpu.gluon.model_zoo.bert import (
        BERTForPretraining as JP, BERTModel as JB)

    tok, tt, vl, labels, nsp = (mnp.array(a) for a in _inputs())
    mx.random.seed(0)
    model = JP(JB(**CFG), vocab_size=VOCAB)
    params = model.collect_params()
    w = _weights({n: p.shape for n, p in params.items()})
    for n, p in params.items():
        p.set_data(mnp.array(w[n]))
    path = tmp_path_factory.mktemp("bert") / "bert.params"
    model.save_parameters(str(path))
    model.hybridize()
    out = {"names": sorted(params)}
    seq, pooled = model.bert(tok)
    out["plain"] = (seq.asnumpy(), pooled.asnumpy())
    seq, pooled = model.bert(tok, tt, vl)
    out["masked"] = (seq.asnumpy(), pooled.asnumpy())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        mlm, nsp_scores = model(tok, tt, vl)
        loss = loss_fn(mlm, labels).mean() + loss_fn(nsp_scores, nsp).mean()
    loss.backward()
    out["pretrain"] = (mlm.asnumpy(), nsp_scores.asnumpy())
    out["loss"] = float(loss.asnumpy())
    out["grads"] = {n: p.grad().asnumpy() for n, p in params.items()}
    return path, out


def test_parameter_names_match_the_reference(ref):
    path, want = ref
    model = _port_model(path)
    assert sorted(model.collect_params()) == want["names"]
    base = bert_base(device="cpu")
    names = list(base.collect_params())
    assert len(names) == 4 + 12 * 12 + 2 + 1
    assert tuple(base.collect_params()["position_embed"].shape) == (512, 768)
    assert tuple(base.collect_params()["word_embed.weight"].shape) == \
        (30522, 768)


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_bert_model_matches_the_reference(ref, case):
    path, want = ref
    model = _port_model(path)
    tok, tt, vl, _, _ = (torch.from_numpy(a) for a in _inputs())
    args = (tok,) if case == "plain" else (tok, tt, vl)
    with torch.no_grad():
        seq, pooled = model.bert(*args)
    assert seq.shape == (B, T, 64) and pooled.shape == (B, 64)
    assert bool(torch.isfinite(seq).all())
    assert _rel(seq.numpy(), want[case][0]) <= RTOL
    assert _rel(pooled.numpy(), want[case][1]) <= RTOL


def test_pretraining_outputs_and_gradients_match_the_reference(ref):
    path, want = ref
    model = _port_model(path)
    tok, tt, vl, labels, nsp = (torch.from_numpy(a) for a in _inputs())
    loss_fn = SoftmaxCrossEntropyLoss()
    with tag.record():
        mlm, nsp_scores = model(tok, tt, vl)
        loss = loss_fn(mlm, labels).mean() + loss_fn(nsp_scores, nsp).mean()
    tag.backward(loss)
    assert mlm.shape == (B, T, VOCAB) and nsp_scores.shape == (B, 2)
    assert _rel(mlm.detach().numpy(), want["pretrain"][0]) <= RTOL
    assert _rel(nsp_scores.detach().numpy(), want["pretrain"][1]) <= RTOL
    assert abs(float(loss.detach()) - want["loss"]) <= \
        RTOL * abs(want["loss"])
    grads = want["grads"]
    for n, p in model.collect_params().items():
        assert _rel(p.grad.numpy(), grads[n]) <= RTOL, n
    # the tied decoder: the word embedding's gradient holds both uses
    emb = model.bert.word_embed.weight.grad
    assert float(emb.abs().max()) > 0


def test_bert_dropout_only_while_training():
    model = BERTModel(**{**CFG, "dropout": 0.5}, device="cpu")
    model.initialize(seed=2)
    tok = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        a = model(tok)[0]
        b = model(tok)[0]
    assert torch.equal(a, b)
    with tag.record():
        c = model(tok)[0]
    assert not torch.equal(a, c.detach())


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bert_kernels_on_the_card(cuda, tmp_path):
    """BERT on the card against the same weights on the CPU: the flash
    kernel's segment-ids branch (non-causal, every key of the length-0 row
    masked) and LayerNorm at eps 1e-12, fp32, within FLASH_TOL 1e-4 of the
    largest entry, with their launch counts."""
    cpu_model = BERTModel(**CFG, device="cpu")
    cpu_model.initialize(seed=3)
    path = tmp_path / "b.params"
    cpu_model.save_parameters(str(path))
    model = BERTModel(**CFG, device=cuda)
    model.load_parameters(str(path))
    tok, tt, vl, _, _ = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        want = cpu_model(tok, tt, vl)
        ck.reset_launch_counts()
        got = model(tok.to(cuda), tt.to(cuda), vl.to(cuda))
        torch.cuda.synchronize()
    counts = ck.launch_counts()
    assert counts["flash_fwd"] == 2 and counts["layer_norm"] == 5
    for g, w in zip(got, want):
        assert _rel(g.cpu().numpy(), w.numpy()) <= 1e-4
    assert float(got[0][2].abs().max()) < float("inf")
