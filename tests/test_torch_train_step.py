"""PyTorch/CUDA port: the compiled train step and the fused update.

The port's ``Trainer.compile_step`` (one CUDA graph a step on the card; the
same body run eagerly on the CPU) and its fused multi-tensor
``Trainer.step`` against the JAX package's ``compile_step`` and against
the port's own eager loop, on twin ``gpt_tiny`` models (dropout 0) fed the
same numpy batches. Tolerances, each with its reason:

- against the JAX package: rtol 1e-4, atol 1e-5 on weights and optimizer
  states after every step (``test_torch_train.py``'s bound: the
  gradients' rounding differences go through Adam's normalisation), and
  rtol 1e-4 on the losses;
- against the port's own eager loop on the CPU: rtol 1e-6 (one body of
  torch ops in another order of calls; it comes out bit-equal here);
- multi-step against single steps, the fused update against the
  per-parameter loop: bitwise (the same arithmetic per element);
- accumulation against one large batch: rtol 1e-5, atol 1e-6
  (sum-then-divide against one mean);
- on the card, compiled against eager: rtol 2e-4, atol 1e-6, the
  reference's cross-program bound (``tests/test_train_step.py:21``).

The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_train_step.py -m cuda`` collects
this file on a machine without JAX.
"""
import math

import numpy as onp
import pytest
import torch

from torch_parity import VOCAB, numpy_weights, twin_gpt

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny
from mxnet_tpu_torch.gluon.trainer import _fused_layout

ADAMW = ("adamw", {"learning_rate": 2e-3, "wd": 0.05, "epsilon": 1e-4})
SGD = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3})
RTOL, ATOL = 1e-4, 1e-5
CUDA_RTOL, CUDA_ATOL = 2e-4, 1e-6


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _nd(a):
    import mxnet_tpu as mx

    return mx.nd.array(onp.asarray(a), dtype=onp.asarray(a).dtype)


def _batches(seed, n, B=3, T=12, lead=()):
    rs = onp.random.RandomState(seed)
    shape = tuple(lead) + (B, T)
    return [(rs.randint(1, VOCAB, size=shape).astype("int32"),
             rs.randint(1, VOCAB, size=shape).astype("int32"))
            for _ in range(n)]


def _jax_trainer(jnet, name, params):
    import mxnet_tpu as mx

    return mx.gluon.Trainer(jnet.collect_params(), name, dict(params))


def _jax_loss(**kw):
    from mxnet_tpu.gluon import loss as jloss

    return jloss.SoftmaxCrossEntropyLoss(**kw)


def _weights_close(jnet, tnet, rtol=RTOL, atol=ATOL):
    jp, tp = jnet.collect_params(), tnet.collect_params()
    for n in jp:
        onp.testing.assert_allclose(tp[n].detach().numpy(),
                                    jp[n].data().asnumpy(), rtol=rtol,
                                    atol=atol, err_msg=n)


def _states_close(jtr, ttr, rtol=RTOL, atol=ATOL):
    assert len(jtr._states) == len(ttr._states)
    for i, (js, ts) in enumerate(zip(jtr._states, ttr._states)):
        assert (js is None) == (ts is None), i
        if js is None:
            continue
        assert set(js) == set(ts), i
        for k in js:
            onp.testing.assert_allclose(ts[k].numpy(), js[k].asnumpy(),
                                        rtol=rtol, atol=atol,
                                        err_msg=f"state {k} of {i}")


def _twin_ports(seed, device="cpu", dropout=0.0, n=2):
    """``n`` port gpt_tiny models holding one set of numpy weights."""
    kw = dict(vocab_size=VOCAB, dropout=dropout, num_layers=2, units=64,
              num_heads=4, max_length=64)
    nets = []
    for _ in range(n):
        net = gpt_tiny(device=device, **kw)
        shapes = {n: tuple(p.shape) for n, p in
                  net.collect_params().items()}
        net.load_dict(numpy_weights(shapes, seed))
        nets.append(net)
    return nets


def _eager_step(net, tr, loss_fn, x, y):
    with tag.record():
        loss = loss_fn(net(x), y).mean()
    tag.backward(loss)
    tr.step(1)
    return loss.detach()


def _same(a, b):
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        assert torch.equal(p.detach(), q.detach()), n


# -- (a) against the JAX package's compile_step --------------------------------
@pytest.mark.parametrize("name,params", [ADAMW, SGD])
def test_compiled_step_matches_jax_compile_step(name, params):
    jnet, tnet = twin_gpt(seed=21)
    jtr = _jax_trainer(jnet, name, params)
    jstep = jtr.compile_step(jnet, _jax_loss())
    ttr = Trainer(tnet.collect_params(), name, dict(params))
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCELoss())
    assert tstep.fallback_reason is None
    for x, y in _batches(3, 4):
        jl = float(jstep(_nd(x), _nd(y)).asnumpy())
        tl = tstep(_t(x), _t(y))
        assert tl.shape == () and not tl.requires_grad
        assert float(tl) == pytest.approx(jl, rel=RTOL)
        _weights_close(jnet, tnet)
    _states_close(jtr, ttr)
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 4
    assert ttr.optimizer._index_update_count == \
        jtr.optimizer._index_update_count
    assert tstep._traces == jstep._traces == 1


# -- (b) against the port's own eager loop -------------------------------------
@pytest.mark.parametrize("name,params", [ADAMW, SGD])
def test_compiled_step_matches_eager_loop(name, params):
    a, b = _twin_ports(seed=22)
    loss_fn = tloss.SoftmaxCELoss()
    ta = Trainer(a.collect_params(), name, dict(params))
    tb = Trainer(b.collect_params(), name, dict(params))
    step = ta.compile_step(a, loss_fn)
    grads = {n: p.grad for n, p in a.collect_params().items()}
    for x, y in _batches(4, 4):
        lc = step(_t(x), _t(y))
        le = _eager_step(b, tb, loss_fn, _t(x), _t(y))
        torch.testing.assert_close(lc, le, rtol=1e-6, atol=0)
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6,
                                   atol=0, msg=n)
    for sa, sb in zip(ta._states, tb._states):
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6, atol=0)
    assert ta.optimizer.num_update == tb.optimizer.num_update == 4
    # the compiled step never touches .grad (the zeros loading attached)
    assert all(p.grad is grads[n] and (p.grad is None or not p.grad.any())
               for n, p in a.collect_params().items())


# -- (c) a schedule advancing every step: one capture --------------------------
def test_lr_schedule_advances_without_recapture():
    """Analog of tests/test_train_step.py:75 and :110: a FactorScheduler
    halving the lr every update, then plain set_learning_rate changes;
    the port and the JAX package agree and each captured/traced once."""
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=23)
    name, params = SGD
    jtr = mx.gluon.Trainer(jnet.collect_params(), name, dict(
        params, lr_scheduler=mx.lr_scheduler.FactorScheduler(
            step=1, factor=0.5, base_lr=0.1)))
    ttr = Trainer(tnet.collect_params(), name, dict(
        params, lr_scheduler=tsched.FactorScheduler(
            step=1, factor=0.5, base_lr=0.1)))
    jstep = jtr.compile_step(jnet, _jax_loss())
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCELoss())
    batches = _batches(6, 6)
    for x, y in batches[:4]:
        jstep(_nd(x), _nd(y))
        tstep(_t(x), _t(y))
        _weights_close(jnet, tnet)
    assert ttr.learning_rate == pytest.approx(jtr.learning_rate)
    for lr, (x, y) in zip((0.01, 0.001), batches[4:]):
        for tr in (jtr, ttr):
            tr.optimizer.lr_scheduler = None
            tr.set_learning_rate(lr)
        jstep(_nd(x), _nd(y))
        tstep(_t(x), _t(y))
        _weights_close(jnet, tnet)
    assert tstep._traces == jstep._traces == 1


# -- (d) the loss scaler's skip against the JAX package -----------------------
def test_loss_scaler_skip_matches_jax():
    """Analog of tests/test_train_step.py:164. Tokens cannot carry an inf,
    so the overflow comes from the scale: at 2**127 a gradient over 2
    overflows float32. This model's largest gradient is ~0.3-0.4, so a loss
    weight of 64 puts it ~10x past the limit in both packages, while the
    gradient that is zero in exact arithmetic (the key bias) stays far
    under Adam's epsilon. The weights stay bitwise, the scale halves,
    num_update stays; at a sane scale the next step trains as JAX's."""
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=24)
    name, params = ADAMW
    w = 64.0
    jtr = _jax_trainer(jnet, name, params)
    ttr = Trainer(tnet.collect_params(), name, dict(params))
    jsc = mx.amp.attach_loss_scaler(
        jtr, mx.amp.DynamicLossScaler(init_scale=1024.0))
    tsc = tamp.attach_loss_scaler(
        ttr, tamp.DynamicLossScaler(init_scale=1024.0))
    jstep = jtr.compile_step(jnet, _jax_loss(weight=w))
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCELoss(weight=w))
    assert tstep.loss_scaler is tsc
    (x1, y1), (x2, y2), (x3, y3) = _batches(7, 3)
    jstep(_nd(x1), _nd(y1))
    tstep(_t(x1), _t(y1))
    _weights_close(jnet, tnet)
    snap_t = {n: p.detach().clone()
              for n, p in tnet.collect_params().items()}
    snap_j = {n: p.data().asnumpy().copy()
              for n, p in jnet.collect_params().items()}
    st_t = [{k: v.clone() for k, v in s.items()} for s in ttr._states]
    jsc.loss_scale = tsc.loss_scale = 2.0 ** 127
    jstep(_nd(x2), _nd(y2))
    tstep(_t(x2), _t(y2))
    for n, p in tnet.collect_params().items():
        assert torch.equal(p.detach(), snap_t[n]), f"{n} moved on overflow"
    for n, p in jnet.collect_params().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), snap_j[n])
    for s0, s1 in zip(st_t, ttr._states):
        for k in s0:
            assert torch.equal(s0[k], s1[k])
    assert tsc.loss_scale == jsc.loss_scale == 2.0 ** 126
    assert tsc._unskipped == jsc._unskipped == 0
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 1
    jsc.loss_scale = tsc.loss_scale = 1024.0
    jstep(_nd(x3), _nd(y3))
    tstep(_t(x3), _t(y3))
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 2
    assert any(not torch.equal(p.detach(), snap_t[n])
               for n, p in tnet.collect_params().items())
    _weights_close(jnet, tnet)
    _states_close(jtr, ttr)
    assert tstep._traces == 1


# -- (e) the semantic fallback -------------------------------------------------
def test_multi_precision_falls_back_to_eager_once():
    """Analog of tests/test_train_step.py:230: the step warns once, names
    its reason, and trains as the eager loop does. The port's compiled step
    captures ``multi_precision`` (its masters are states of the update;
    ``tests/test_torch_optimizers.py`` holds that path), so the fallback is
    shown with SGLD, the one optimizer without a fused step; its noise
    draws from the port's generator, reseeded before each twin's step."""
    import warnings

    from mxnet_tpu_torch import random as trandom

    a, b = _twin_ports(seed=25)
    loss_fn = tloss.SoftmaxCELoss()
    params = {"learning_rate": 0.05, "multi_precision": True}
    ta = Trainer(a.collect_params(), "sgld", dict(params))
    tb = Trainer(b.collect_params(), "sgld", dict(params))
    step = ta.compile_step(a, loss_fn)
    assert "SGLD declares no fusable" in step.fallback_reason
    assert Trainer(a.collect_params(), "sgd", dict(params)).compile_step(
        a, loss_fn).fallback_reason is None
    batches = _batches(8, 3)
    step = _reseeded(step, trandom)
    eager = _reseeded(_eager_step, trandom)
    with pytest.warns(RuntimeWarning, match="falling back"):
        loss = step(*map(_t, batches[0]))
    assert math.isfinite(float(loss))
    eager(b, tb, loss_fn, *map(_t, batches[0]))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for x, y in batches[1:]:
            step(_t(x), _t(y))
            eager(b, tb, loss_fn, _t(x), _t(y))
    assert not [r for r in rec if issubclass(r.category, RuntimeWarning)]
    _same(a, b)
    with pytest.raises(MXNetError, match="eager"):
        step.compile_multi_step(2)


def _reseeded(fn, trandom, seed=7):
    """``fn`` with the port's generators reseeded before each call, so two
    twins draw the same noise."""
    def run(*args):
        trandom.seed(seed)
        return fn(*args)

    run.compile_multi_step = getattr(fn, "compile_multi_step", None)
    return run


def test_step_fn_requires_compile_and_mesh_is_not_ported():
    (net,) = _twin_ports(seed=26, n=1)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with pytest.raises(MXNetError, match="compile_step"):
        tr.step_fn
    for kw in ({"mesh": object()}, {"shard_update": True},
               {"shard_params": True}):
        with pytest.raises(MXNetError, match="not ported"):
            tr.compile_step(net, tloss.SoftmaxCELoss(), **kw)
    step = tr.compile_step(net, tloss.SoftmaxCELoss(), shard_update=False)
    assert tr.step_fn is step


# -- (f) multi-step and accumulation ------------------------------------------
def _run_port(net, batches, multi, name="sgd", params=None, scaler=None,
              sched=None, loss_fn=None):
    if isinstance(net, int):
        (net,) = _twin_ports(net, n=1)
    p = dict(params or SGD[1])
    if sched is not None:
        p["lr_scheduler"] = sched
    tr = Trainer(net.collect_params(), name, p)
    loss_fn = loss_fn or tloss.SoftmaxCELoss()
    xs = _t(onp.stack([b[0] for b in batches]))
    ys = _t(onp.stack([b[1] for b in batches]))
    if multi:
        step = tr.compile_step(net, loss_fn, loss_scaler=scaler,
                               multi_step=len(batches))
        losses = step(xs, ys)
    else:
        step = tr.compile_step(net, loss_fn, loss_scaler=scaler)
        losses = torch.stack([step(xs[j], ys[j])
                              for j in range(len(batches))])
    return losses, net, tr, step


def test_multi_step_matches_single_steps_and_jax():
    """Analog of tests/test_multi_step.py:92: K=4 steps in one call equal
    4 single compiled steps bitwise, and the JAX package's K=4 scan."""
    batches = _batches(9, 4)
    jnet, tnet = twin_gpt(seed=27)
    l1, n1, t1, _ = _run_port(27, batches, multi=False)
    l2, n2, t2, step = _run_port(tnet, batches, multi=True)
    assert l2.shape == (4,)
    assert torch.equal(l1, l2)
    _same(n1, n2)
    assert t1.optimizer.num_update == t2.optimizer.num_update == 4
    assert step._traces == 1
    jtr = _jax_trainer(jnet, *SGD)
    jstep = jtr.compile_step(jnet, _jax_loss(), multi_step=4)
    jl = jstep(_nd(onp.stack([b[0] for b in batches])),
               _nd(onp.stack([b[1] for b in batches]))).asnumpy()
    onp.testing.assert_allclose(l2.numpy(), jl, rtol=RTOL)
    _weights_close(jnet, tnet)


class _InfOnLabelZero(tloss.SoftmaxCELoss):
    """Per-sample cross entropy times inf for rows whose first label is 0:
    a batch holding such a row overflows under any loss scale."""

    def forward(self, pred, label, sample_weight=None):
        loss = super().forward(pred, label, sample_weight)
        boost = torch.where(label[:, 0] == 0, math.inf, 1.0)
        return loss * boost.to(loss.dtype)


def test_multi_step_overflow_skips_inner_update():
    """Analog of tests/test_multi_step.py:118: inner step 2 of 4
    overflows; the call skips exactly that update, halves the scale once
    and lands where 4 single steps land."""
    batches = _batches(10, 4)
    batches[2][1][0, 0] = 0
    outs = []
    for multi in (False, True):
        sc = tamp.DynamicLossScaler(init_scale=2.0 ** 8)
        _, net, tr, _ = _run_port(28, batches, multi, *ADAMW, scaler=sc,
                                  loss_fn=_InfOnLabelZero())
        outs.append((net, tr, sc))
    (n1, t1, s1), (n2, t2, s2) = outs
    _same(n1, n2)
    assert s1.loss_scale == s2.loss_scale == 2.0 ** 7
    assert t1.optimizer.num_update == t2.optimizer.num_update == 3


def test_multi_step_lr_schedule_advances_inside_a_call():
    """Analog of tests/test_multi_step.py:137: a per-update schedule
    advances across the inner steps (bitwise against single steps), and a
    second call reads fresh rows without capturing again."""
    batches = _batches(11, 4)
    mk = lambda: tsched.FactorScheduler(step=1, factor=0.5, base_lr=0.1)
    _, n1, _, _ = _run_port(29, batches, False, sched=mk())
    _, n2, t2, step = _run_port(29, batches, True, sched=mk())
    _same(n1, n2)
    assert step._traces == 1
    more = _batches(12, 4)
    step(_t(onp.stack([b[0] for b in more])),
         _t(onp.stack([b[1] for b in more])))
    assert step._traces == 1
    assert t2.optimizer.num_update == 8
    assert t2.learning_rate == pytest.approx(0.1 * 0.5 ** 8)


def test_accumulate_matches_large_batch_and_jax():
    """Analog of tests/test_multi_step.py:160 (mesh False): accumulate=4
    over [4, 3, T] microbatches against one 12-row batch, and against the
    JAX package's accumulate at mesh None."""
    import mxnet_tpu as mx

    ((xs, ys),) = _batches(13, 1, lead=(4,))
    a, b = _twin_ports(seed=30)
    ta = Trainer(a.collect_params(), *ADAMW)
    tb = Trainer(b.collect_params(), *ADAMW)
    sa = ta.compile_step(a, tloss.SoftmaxCELoss(), accumulate=4)
    sb = tb.compile_step(b, tloss.SoftmaxCELoss())
    la = sa(_t(xs), _t(ys))
    lb = sb(_t(xs.reshape(12, -1)), _t(ys.reshape(12, -1)))
    assert la.shape == (1,)
    assert float(la[0]) == pytest.approx(float(lb), rel=1e-5)
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-5,
                                   atol=1e-6, msg=n)
    jnet, tnet = twin_gpt(seed=31)
    ttr = Trainer(tnet.collect_params(), *ADAMW)
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCELoss(), accumulate=4)
    jtr = mx.gluon.Trainer(jnet.collect_params(), *ADAMW)
    jstep = jtr.compile_step(jnet, _jax_loss(), accumulate=4)
    jl = jstep(_nd(xs), _nd(ys)).asnumpy().reshape(-1)
    tl = tstep(_t(xs), _t(ys))
    onp.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL)
    _weights_close(jnet, tnet)


# -- (g) input validation ------------------------------------------------------
def test_split_super_validation_and_env(monkeypatch):
    """Analogs of tests/test_multi_step.py:220 and :229."""
    (net,) = _twin_ports(seed=32, n=1)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    ((xs, ys),) = _batches(14, 1, lead=(4,))
    step = tr.compile_step(net, tloss.SoftmaxCELoss(), multi_step=4)
    with pytest.raises(MXNetError, match="leading axes"):
        step(_t(xs), _t(ys[:3]))
    with pytest.raises(MXNetError, match=r"\[K, batch"):
        step(_t(xs[0, 0]), _t(ys[0, 0]))
    acc = tr.compile_step(net, tloss.SoftmaxCELoss(), accumulate=4)
    with pytest.raises(MXNetError, match=r"\[G, batch"):
        acc(_t(xs[:3]), _t(ys[:3]))
    both = tr.compile_step(net, tloss.SoftmaxCELoss(), multi_step=2,
                           accumulate=4)
    with pytest.raises(MXNetError, match=r"\[K, G, batch"):
        both(_t(xs), _t(ys))
    with pytest.raises(MXNetError, match="must be >= 1"):
        tr.compile_step(net, tloss.SoftmaxCELoss(), multi_step=0)
    with pytest.raises(MXNetError, match="must be >= 1"):
        step.compile_multi_step(4, accumulate=0)
    # a trailing group shorter than K reuses the program; a longer one
    # captures anew with more table rows
    step(_t(xs[:2]), _t(ys[:2]))
    assert step._traces == 1
    ((x6, y6),) = _batches(15, 1, lead=(6,))
    assert step(_t(x6), _t(y6)).shape == (6,)
    assert step._traces == 2
    monkeypatch.setenv("MXTPU_MULTI_STEP", "4")
    assert tr.compile_step(net, tloss.SoftmaxCELoss()).multi_step == 4
    monkeypatch.setenv("MXTPU_MULTI_STEP", "0")
    assert tr.compile_step(net, tloss.SoftmaxCELoss(),
                           multi_step=3).multi_step is None


# -- (h) the fused eager update ------------------------------------------------
def _gpt_shapes(vocab, max_length, units, num_layers):
    """The trainables' shapes of the port's GPTModel, in collect_params
    order (tied head, 4x FFN)."""
    block = [(units,), (units,), (3 * units, units), (3 * units,),
             (units, units), (units,), (units,), (units,),
             (4 * units, units), (4 * units,), (units, 4 * units), (units,)]
    return [(vocab, units), (max_length, units)] + block * num_layers + \
        [(units,), (units,)]


def _layout_calls(shapes):
    ws = [torch.empty(s, device="meta") for s in shapes]
    return _fused_layout(ws, [{}] * len(ws), (), True).calls


def test_fused_update_is_bitwise_and_calls_the_recurrence_51_times(
        monkeypatch):
    """The fused Trainer.step (the default) equals MXNET_FUSED_TRAINER=0
    bitwise; it calls the recurrence once per tensor over 4096 elements
    and once for all smaller ones: 51 calls for GPT-2 small's 148
    trainables (reckoned from its shapes, which are checked against a
    built model's at a small size)."""
    tiny = dict(vocab=VOCAB, max_length=64, units=64, num_layers=2)
    (ref,) = _twin_ports(seed=33, n=1)
    assert _gpt_shapes(**tiny) == [tuple(p.shape) for p in
                                   ref.collect_params().values()]
    gpt2 = _gpt_shapes(vocab=50257, max_length=1024, units=768,
                       num_layers=12)
    assert len(gpt2) == 148
    assert sum(math.prod(s) > 4096 for s in gpt2) == 50
    assert _layout_calls(gpt2) == 51
    for name, params in (ADAMW, SGD):
        a, b = _twin_ports(seed=33)
        ta = Trainer(a.collect_params(), name, dict(params))
        tb = Trainer(b.collect_params(), name, dict(params))
        tb._fuse = False             # what MXNET_FUSED_TRAINER=0 sets
        raw, keys, needs_t, ew = ta.optimizer.fused_step
        calls = []

        def counted(*args, _raw=raw):
            calls.append(args[0].numel())
            return _raw(*args)

        ta.optimizer._fusable = (counted, keys, needs_t, ew)
        loss_fn = tloss.SoftmaxCELoss()
        steps = _batches(16, 3)
        for x, y in steps:
            _eager_step(a, ta, loss_fn, _t(x), _t(y))
            _eager_step(b, tb, loss_fn, _t(x), _t(y))
            _same(a, b)
            for sa, sb in zip(ta._states, tb._states):
                for k in sa:
                    assert torch.equal(sa[k], sb[k])
        per_step = _layout_calls(_gpt_shapes(**tiny))
        assert len(calls) == ta._fused_calls == per_step * len(steps)
        assert ta._fused_dispatches == len(steps)
        assert ta._fused_traces == 1 and tb._fused_calls == 0
    monkeypatch.setenv("MXNET_FUSED_TRAINER", "0")
    assert not Trainer(a.collect_params(), "sgd")._fuse


# -- (i) checkpoints around the compiled step ----------------------------------
def test_save_load_states_around_compiled_step(tmp_path):
    """Two compiled steps; save the states and the weights; a third step
    moves both; loading them back into the same compiled trainer (in
    place: no new capture) and training on equals the JAX package, which
    also loads the port's state file."""
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=34)
    name, params = ADAMW
    jtr = _jax_trainer(jnet, name, params)
    ttr = Trainer(tnet.collect_params(), name, dict(params))
    jstep = jtr.compile_step(jnet, _jax_loss())
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCELoss())
    batches = _batches(17, 5)
    for x, y in batches[:2]:
        jstep(_nd(x), _nd(y))
        tstep(_t(x), _t(y))
    states = str(tmp_path / "port.states")
    weights = str(tmp_path / "port.params")
    ttr.save_states(states)
    tnet.save_parameters(weights)
    tstep(*map(_t, batches[2]))          # a step that is then undone
    assert ttr.optimizer.num_update == 3
    ttr.load_states(states)
    tnet.load_parameters(weights)
    assert ttr.optimizer.num_update == 2
    jtr2 = mx.gluon.Trainer(jnet.collect_params(), name, dict(params))
    jtr2.load_states(states)
    jstep2 = jtr2.compile_step(jnet, _jax_loss())
    for x, y in batches[3:]:
        jl = float(jstep2(_nd(x), _nd(y)).asnumpy())
        tl = float(tstep(_t(x), _t(y)))
        assert tl == pytest.approx(jl, rel=RTOL)
        _weights_close(jnet, tnet)
    _states_close(jtr2, ttr)
    assert ttr.optimizer.num_update == jtr2.optimizer.num_update == 4
    assert tstep._traces == 1
    # a state replaced (not written in place) makes the step capture anew
    ttr._states[0] = {k: v.clone() for k, v in ttr._states[0].items()}
    tstep(*map(_t, batches[0]))
    assert tstep._traces == 2


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the compiled step captures a CUDA "
                    "graph of the CUDA kernels, which have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_compiled_step_matches_eager_on_card(cuda):
    """The warm step, the capture and the replays against the eager
    Trainer on twin models on the card; the captured body launched each
    kernel of the eager step."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    a, b = _twin_ports(seed=40, device=cuda)
    loss_fn = tloss.SoftmaxCELoss()
    ta = Trainer(a.collect_params(), *ADAMW)
    tb = Trainer(b.collect_params(), *ADAMW)
    step = ta.compile_step(a, loss_fn)
    for i, (x, y) in enumerate(_batches(18, 4)):
        x, y = _t(x).to(cuda), _t(y).to(cuda)
        lc = step(x, y)
        le = _eager_step(b, tb, loss_fn, x, y)
        torch.testing.assert_close(lc, le, rtol=CUDA_RTOL, atol=CUDA_ATOL)
        for (n, p), q in zip(a.collect_params().items(),
                             b.collect_params().values()):
            torch.testing.assert_close(p, q, rtol=CUDA_RTOL,
                                       atol=CUDA_ATOL, msg=f"{n} step {i}")
        if i == 0:
            assert step._traces == 1 and step._cache
    for sa, sb in zip(ta._states, tb._states):
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=CUDA_RTOL,
                                       atol=CUDA_ATOL)
    assert step._traces == 1
    assert step.captured_launches == {
        "flash_fwd": 2, "flash_bwd_dkv": 2, "flash_bwd_dq": 2,
        "layer_norm": 5, "softmax": 0}
    assert ck.launch_counts()["flash_fwd"] > 0


@pytest.mark.cuda
def test_replays_draw_fresh_dropout_masks(cuda):
    """lr 0 and dropout 0.5: two replays on one batch give different
    losses (the generator is registered with the graph), and after
    random.seed(s) the first loss repeats."""
    (net,) = _twin_ports(seed=41, device=cuda, dropout=0.5, n=1)
    tr = Trainer(net.collect_params(), "adamw", {"learning_rate": 0.0})
    step = tr.compile_step(net, tloss.SoftmaxCELoss())
    ((x, y),) = _batches(19, 1)
    x, y = _t(x).to(cuda), _t(y).to(cuda)
    step(x, y)                           # warm step and capture
    mxt.random.seed(5)
    l1, l2 = float(step(x, y)), float(step(x, y))
    mxt.random.seed(5)
    l3 = float(step(x, y))
    assert l1 != l2
    assert l3 == l1
    assert step._traces == 1


@pytest.mark.cuda
def test_load_dict_and_load_states_reach_the_graph(cuda, tmp_path):
    """Weights and states loaded after the capture are read by the next
    replay (written in place, no new capture); a replaced state makes the
    step capture anew."""
    (net,) = _twin_ports(seed=42, device=cuda, n=1)
    tr = Trainer(net.collect_params(), *ADAMW)
    step = tr.compile_step(net, tloss.SoftmaxCELoss())
    batches = [(_t(x).to(cuda), _t(y).to(cuda)) for x, y in _batches(20, 4)]
    for x, y in batches[:2]:
        step(x, y)
    snap = {n: p.detach().clone() for n, p in net.collect_params().items()}
    path = str(tmp_path / "s.states")
    tr.save_states(path)
    l3 = float(step(*batches[2]))
    after3 = {n: p.detach().clone() for n, p in net.collect_params().items()}
    step(*batches[3])
    net.load_dict(snap)
    tr.load_states(path)
    assert float(step(*batches[2])) == l3
    for n, p in net.collect_params().items():
        assert torch.equal(p.detach(), after3[n]), n
    assert step._traces == 1
    tr._states[0] = {k: v.clone() for k, v in tr._states[0].items()}
    net.load_dict(snap)
    tr.load_states(path)
    assert float(step(*batches[2])) == pytest.approx(l3, rel=1e-6)
    assert step._traces == 2


@pytest.mark.cuda
def test_fused_update_matches_per_parameter_loop_on_card(cuda):
    """The fused eager update against MXNET_FUSED_TRAINER=0 on the card,
    three AdamW steps: rtol 1e-6, atol 1e-6. On CUDA the loop's division
    by a Python scalar runs as a multiply by its reciprocal, the fused
    path's by a 0-dim device tensor as a division: the weights part by an
    ulp after one step, and the key bias (a gradient that is zero in exact
    arithmetic, ~1e-8 of rounding noise) moves by up to lr x noise /
    epsilon ~ 2e-7 a step on that difference."""
    a, b = _twin_ports(seed=43, device=cuda)
    ta = Trainer(a.collect_params(), *ADAMW)
    tb = Trainer(b.collect_params(), *ADAMW)
    tb._fuse = False
    loss_fn = tloss.SoftmaxCELoss()
    for x, y in _batches(21, 3):
        x, y = _t(x).to(cuda), _t(y).to(cuda)
        _eager_step(a, ta, loss_fn, x, y)
        _eager_step(b, tb, loss_fn, x, y)
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6, msg=n)
    assert ta._fused_calls == 3 * _layout_calls(
        [tuple(p.shape) for p in a.collect_params().values()])
    assert tb._fused_calls == 0
