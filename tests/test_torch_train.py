"""PyTorch/CUDA port: the training slice against the JAX package.

The same numpy inputs (``RandomState(seed)``) go through the JAX package's
optimizers, schedules, losses, ``autograd`` and ``Trainer`` and through the
port's, on the CPU. Tolerances, each with its reason:

- optimizer recurrences and losses: rtol 1e-5 (the same fp32 arithmetic;
  the port computes Adam's bias correction ``b ** t`` in double, the
  reference in fp32), and atol 1e-6 for the recurrences, about ten fp32
  steps of their O(1) weights, for entries that cancel towards zero;
- GPT parameter gradients: max |diff| <= 1e-5 relative to each gradient's
  largest entry (sums in another order);
- weights of twin GPT models trained by the two Trainers: rtol 1e-4,
  atol 1e-5 after every step (the gradients' rounding differences go
  through Adam's normalisation and compound over the steps). Adam runs
  there with epsilon 1e-4: the key projection's bias has a gradient that
  is zero in exact arithmetic (softmax ignores a shift common to all
  keys) and ~1e-8 of rounding noise in either package, which epsilon
  1e-8 would turn into full +-lr steps of random sign.
"""
import numpy as onp
import pytest
import torch

from torch_parity import VOCAB, twin_gpt

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny
from mxnet_tpu_torch.ops import nn as tnn


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _j(a):
    from mxnet_tpu import np as mnp

    return mnp.array(onp.asarray(a))


def _nd(a):
    from mxnet_tpu.ndarray.ndarray import NDArray

    return NDArray(onp.asarray(a))


# -- LR schedules ------------------------------------------------------------
def _schedules(mod):
    return [
        mod.FactorScheduler(step=3, factor=0.5, base_lr=0.1,
                            warmup_steps=2),
        mod.MultiFactorScheduler(step=[4, 7], factor=0.3, base_lr=0.2),
        mod.PolyScheduler(max_update=12, base_lr=0.1, pwr=2, final_lr=0.01,
                          warmup_steps=3, warmup_begin_lr=0.02),
        mod.CosineScheduler(max_update=10, base_lr=0.3, final_lr=0.05,
                            warmup_steps=2, warmup_mode="constant",
                            warmup_begin_lr=0.01),
    ]


def test_lr_schedules_match_reference():
    from mxnet_tpu import lr_scheduler as jsched

    for j, t in zip(_schedules(jsched), _schedules(tsched)):
        for n in range(0, 16):
            assert t(n) == j(n), (type(t).__name__, n)


# -- optimizer recurrences ----------------------------------------------------
OPTIMIZERS = [
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.9}),
    ("nag", {"momentum": 0.8}),
    ("adam", {}),
    ("adamw", {}),
]


@pytest.mark.parametrize("name,extra", OPTIMIZERS)
def test_optimizer_recurrences_match_reference(name, extra):
    """5 updates of two parameters with wd, clip_gradient, rescale_grad, a
    per-index lr_mult and a schedule."""
    from mxnet_tpu import lr_scheduler as jsched
    from mxnet_tpu import optimizer as jopt

    rs = onp.random.RandomState(21)
    kw = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.4,
              rescale_grad=0.5, **extra)
    jo = jopt.create(name, lr_scheduler=jsched.FactorScheduler(
        step=2, factor=0.7, base_lr=0.05), **kw)
    to = topt.create(name, lr_scheduler=tsched.FactorScheduler(
        step=2, factor=0.7, base_lr=0.05), **kw)
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({0: 2.0})
    ws = [rs.randn(6, 5).astype("float32"), rs.randn(7).astype("float32")]
    jw = [_nd(w) for w in ws]
    tw = [_t(w.copy()) for w in ws]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for _ in range(5):
        for i in range(2):
            g = (rs.randn(*ws[i].shape) * 1.5).astype("float32")
            jo.update(i, jw[i], _nd(g), js[i])
            to.update(i, tw[i], _t(g), ts[i])
            onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(),
                                        rtol=1e-5, atol=1e-6)
            for k in js[i]:
                onp.testing.assert_allclose(ts[i][k].numpy(),
                                            js[i][k].asnumpy(), rtol=1e-5,
                                            atol=1e-6)
    assert to.num_update == jo.num_update == 5
    assert to.learning_rate == pytest.approx(jo.learning_rate)


def test_optimizer_registry_and_clip_off():
    with pytest.raises(MXNetError, match="not registered"):
        topt.create("no_such_optimizer")
    assert isinstance(topt.create("LAMB"), topt.LAMB)
    o = topt.create("sgd", learning_rate=1.0, clip_gradient=0.0)
    w = torch.zeros(3)
    o.update(0, w, torch.tensor([5.0, -5.0, 1.0]), {})
    assert torch.equal(w, torch.tensor([-5.0, 5.0, -1.0]))   # <= 0: off


def test_multi_precision_updates_a_float32_master():
    o = topt.create("sgd", learning_rate=1e-3, momentum=0.9,
                    multi_precision=True)
    w = torch.ones(4, dtype=torch.bfloat16)
    st = o.create_state_multi_precision(0, w)
    assert st["weight_fp32"].dtype == torch.float32
    assert st["mom"].dtype == torch.float32
    for _ in range(3):
        o.update(0, w, torch.ones(4, dtype=torch.bfloat16), st)
    # bf16 cannot hold 1 - 3e-3 steps apart; the master can
    assert float(st["weight_fp32"][0]) == pytest.approx(1 - 1e-3 * (
        1 + 1.9 + 2.71), rel=1e-5)
    assert torch.equal(w, st["weight_fp32"].to(torch.bfloat16))


# -- losses ------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["sparse", "sparse_weighted", "dense",
                                  "from_logits", "l2"])
def test_losses_match_reference(kind):
    from mxnet_tpu.gluon import loss as jloss

    rs = onp.random.RandomState(5)
    pred = (rs.randn(4, 6, 9) * 2).astype("float32")
    label = rs.randint(0, 9, size=(4, 6)).astype("int32")
    args, kw = (), {}
    if kind == "l2":
        label = rs.randn(4, 6, 9).astype("float32")
        jl, tl = jloss.L2Loss(), tloss.L2Loss()
    elif kind == "dense":
        label = rs.rand(4, 6, 9).astype("float32")
        label /= label.sum(-1, keepdims=True)
        kw = {"sparse_label": False}
    elif kind == "from_logits":
        pred = pred - onp.log(onp.exp(pred).sum(-1, keepdims=True))
        kw = {"from_logits": True}
    if kind == "sparse_weighted":
        args = (rs.rand(4, 6).astype("float32"),)
        kw = {"weight": 0.7}
    if kind != "l2":
        jl = jloss.SoftmaxCrossEntropyLoss(**kw)
        tl = tloss.SoftmaxCELoss(**kw)
    want = jl(_j(pred), _j(label), *[_j(a) for a in args]).asnumpy()
    got = tl(_t(pred), _t(label), *[_t(a) for a in args]).numpy()
    assert got.shape == want.shape == (4,)
    onp.testing.assert_allclose(got, want, rtol=1e-5)


# -- autograd and dropout -----------------------------------------------------
def test_autograd_scopes_and_dropout_semantics():
    assert not tag.is_recording() and not tag.is_training()
    x = torch.ones(2000)
    assert tnn.dropout(x, 0.5) is x
    with tag.record():
        assert tag.is_recording() and tag.is_training()
        assert torch.is_grad_enabled()
        d = tnn.dropout(x, 0.5)
        assert 0.35 < float((d == 0).float().mean()) < 0.65
        with tag.pause():
            assert not tag.is_recording() and not torch.is_grad_enabled()
            assert tnn.dropout(x, 0.5) is x
        with tag.predict_mode():
            assert tnn.dropout(x, 0.5) is x
    with tag.record(train_mode=False):
        assert tnn.dropout(x, 0.5) is x
    with tag.train_mode():
        assert tnn.dropout(x, 0.5) is not x
    assert not tag.is_recording() and not tag.is_training()
    # the device generator of mxnet_tpu_torch.random: seeded, reproducible
    mxt.random.seed(7)
    a = tnn.dropout(x, 0.5, training=True)
    mxt.random.seed(7)
    assert torch.equal(a, tnn.dropout(x, 0.5, training=True))


def test_autograd_backward_and_grad():
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    u = torch.tensor([3.0], requires_grad=True)
    with tag.record():
        y = (w * w).sum()
    gw, gu = tag.grad(y, [w, u], retain_graph=True)
    assert torch.equal(gw, torch.tensor([2.0, 4.0]))
    assert torch.equal(gu, torch.zeros(1))     # not reached: zeros
    tag.backward(y, head_grads=torch.tensor(2.0))
    assert torch.equal(w.grad, torch.tensor([4.0, 8.0]))


def test_gpt_dropout_only_when_training():
    net = gpt_tiny(vocab_size=VOCAB, num_layers=1, units=32, num_heads=2,
                   max_length=16, dropout=0.3, device="cpu")
    net.initialize(seed=0)
    toks = _t(onp.arange(1, 11, dtype="int32").reshape(1, 10))
    base = net(toks)
    assert torch.equal(net(toks), base)          # outside record: identity
    with tag.record():
        mxt.random.seed(3)
        a = net(toks)
        mxt.random.seed(3)
        b = net(toks)
    assert not torch.equal(a, base) and torch.equal(a, b)
    net.train()                                  # the torch idiom, too
    assert not torch.equal(net(toks), base)
    net.eval()


# -- parameters: grad_req ----------------------------------------------------
def _loss_both(jnet, tnet, toks, vl, tgt):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import loss as jloss

    with mx.autograd.record():
        jl = jloss.SoftmaxCrossEntropyLoss()(jnet(_j(toks), _j(vl)), _j(tgt))
    jl.backward()
    with tag.record():
        tl = tloss.SoftmaxCrossEntropyLoss()(tnet(_t(toks), _t(vl)),
                                            _t(tgt))
    tag.backward(tl)     # per-sample losses: seeded with ones, as jl's
    return jl.asnumpy(), tl.detach().numpy()


def _batch(rs, B=3, T=12, pad=True):
    toks = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    tgt = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    vl = onp.full((B,), T, "int32")
    if pad:
        vl[1] = T - 5          # one row right-padded
    return toks, vl, tgt


def _grads_close(jnet, tnet, tol=1e-5):
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for n in jp:
        want = jp[n].grad().asnumpy()
        got = tp[n].grad.numpy()
        scale = max(float(onp.abs(want).max()), 1e-6)
        assert float(onp.abs(got - want).max()) <= tol * scale, n


@pytest.mark.parametrize("pad", [False, True])
def test_gpt_parameter_gradients_match(pad):
    """Every parameter's gradient, tied embedding included (it takes the
    embedding lookup's and the LM head's), right-padded rows included."""
    jnet, tnet = twin_gpt(seed=11)
    rs = onp.random.RandomState(2)
    jl, tl = _loss_both(jnet, tnet, *_batch(rs, pad=pad))
    onp.testing.assert_allclose(tl, jl, rtol=1e-5)
    _grads_close(jnet, tnet)
    head = tnet.tok_embed.weight.grad
    assert float(head.abs().sum()) > 0


def test_grad_req_write_and_add_match_reference():
    """Two backward calls before one update: 'write' keeps the second
    gradient, 'add' the sum — in both packages."""
    jnet, tnet = twin_gpt(seed=12)
    names = list(tnet.collect_params())
    add = set(names[::2])
    for n in add:
        jnet.collect_params()[n].grad_req = "add"
        tnet.collect_params()[n].grad_req = "add"
    for n, p in tnet.collect_params().items():
        assert p.grad_req == ("add" if n in add else "write")
    rs = onp.random.RandomState(4)
    _loss_both(jnet, tnet, *_batch(rs))
    _loss_both(jnet, tnet, *_batch(rs))
    _grads_close(jnet, tnet)
    p = tnet.collect_params()[names[0]]
    p.zero_grad()
    assert not p.grad.any()


def test_grad_req_null_freezes_a_parameter():
    _, tnet = twin_gpt(seed=13)
    p = tnet.collect_params()["ln_f.gamma"]
    p.grad_req = "null"
    assert not p.requires_grad and p.grad is None
    before = p.detach().clone()
    tr = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.1})
    rs = onp.random.RandomState(1)
    toks, vl, tgt = _batch(rs)
    with tag.record():
        loss = tloss.SoftmaxCELoss()(tnet(_t(toks), _t(vl)), _t(tgt))
    tag.backward(loss)
    tr.step(3)
    assert torch.equal(p.detach(), before)
    assert not torch.equal(tnet.collect_params()["ln_f.beta"].detach(),
                           torch.zeros(64))
    with pytest.raises(MXNetError, match="grad_req"):
        p.grad_req = "sometimes"


# -- the Trainer on twin GPT models -------------------------------------------
def _train_both(jnet, tnet, jtr, ttr, rs, steps, pad_step=1):
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import loss as jloss

    for s in range(steps):
        toks, vl, tgt = _batch(rs, pad=s == pad_step)
        with mx.autograd.record():
            jl = jloss.SoftmaxCrossEntropyLoss()(jnet(_j(toks), _j(vl)),
                                                 _j(tgt))
        jl.backward()
        jtr.step(toks.shape[0])
        with tag.record():
            tl = tloss.SoftmaxCrossEntropyLoss()(tnet(_t(toks), _t(vl)),
                                                _t(tgt))
        tag.backward(tl)
        ttr.step(toks.shape[0])
        _weights_close(jnet, tnet)


def _weights_close(jnet, tnet):
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for n in jp:
        onp.testing.assert_allclose(tp[n].detach().numpy(),
                                    jp[n].data().asnumpy(), rtol=1e-4,
                                    atol=1e-5, err_msg=n)


@pytest.mark.parametrize("name,params", [
    ("adamw", {"learning_rate": 2e-3, "wd": 0.05, "epsilon": 1e-4}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
])
def test_trainer_matches_reference_on_twin_gpt(name, params):
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=14)
    jtr = mx.gluon.Trainer(jnet.collect_params(), name, dict(params))
    ttr = Trainer(tnet.collect_params(), name, dict(params))
    _train_both(jnet, tnet, jtr, ttr, onp.random.RandomState(8), steps=5)
    assert ttr.learning_rate == jtr.learning_rate
    assert ttr.optimizer.num_update == 5


def test_trainer_loads_reference_states_and_keeps_training(tmp_path):
    """JAX save_states -> port load_states, then both train on."""
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=15)
    params = {"learning_rate": 2e-3, "wd": 0.01, "epsilon": 1e-4}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(params))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(params))
    rs = onp.random.RandomState(9)
    _train_both(jnet, tnet, jtr, ttr, rs, steps=2)
    path = str(tmp_path / "jax.states")
    jtr.save_states(path)
    fresh = Trainer(tnet.collect_params(), "adamw", dict(params))
    fresh.load_states(path)
    assert fresh.optimizer.num_update == 2
    assert fresh.optimizer._index_update_count == \
        jtr.optimizer._index_update_count
    _train_both(jnet, tnet, jtr, fresh, rs, steps=2, pad_step=0)
    # and back: the port's file loads into the JAX Trainer
    back = str(tmp_path / "port.states")
    fresh.save_states(back)
    jtr2 = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(params))
    jtr2.load_states(back)
    assert jtr2.optimizer.num_update == 4


def test_trainer_state_conversion_checks_shapes():
    _, tnet = twin_gpt(seed=16)
    tr = Trainer(tnet.collect_params(), "adam", {"learning_rate": 1e-3})
    bad = {"states": [None] * 3, "num_update": 0, "index_count": {}}
    with pytest.raises(MXNetError, match="entries"):
        tr.load_states_payload(bad)
    n = len(tnet.collect_params())
    bad = {"states": [{"mean": onp.zeros(3, "float32")}] + [None] * (n - 1),
           "num_update": 1, "index_count": {0: 1}}
    with pytest.raises(MXNetError, match="tok_embed.weight"):
        tr.load_states_payload(bad)
    with pytest.raises(MXNetError, match="kvstore"):
        Trainer(tnet.collect_params(), "sgd", kvstore="dist_sync")


# -- the copy task (analog of tests/test_gpt_model.py:34) ---------------------
def test_gpt_trains_on_copy_task():
    """Next-token loss on a deterministic cyclic sequence must fall fast."""
    vocab = 12
    net = gpt_tiny(vocab_size=vocab, dropout=0.0, num_layers=1, units=32,
                   num_heads=2, device="cpu")
    net.initialize(seed=1)
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    seq = onp.tile(onp.arange(vocab), 3)[None, :24].astype("int32")
    inp, tgt = _t(seq[:, :-1]), _t(seq[:, 1:])
    losses = []
    for _ in range(25):
        with tag.record():
            logp = tnn.log_softmax(net(inp), axis=-1)
            nll = -tnn.pick(logp, tgt, axis=-1).mean()
        nll.backward()
        tr.step(1)
        losses.append(float(nll.detach()))
    assert losses[-1] < losses[0] * 0.5, losses[::6]
