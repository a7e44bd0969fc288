"""PyTorch/CUDA port: automatic mixed precision against the JAX package.

The port's ``amp`` (the state, the cast at the op, ``convert_hybrid_block``,
the loss scaling) against ``mxnet_tpu.amp`` on the same numpy inputs, on the
CPU: the port's kernel wrappers run their plain versions, the JAX package
its reference paths. Tolerances, each with its reason:

- an op's output under AMP (bf16): max |diff| <= 1.6e-2 |ref| + 1.6e-2
  max |ref| / 8 — two bf16 steps (2 x 2^-7) of the value; both packages
  round the same products to bf16, once or twice in another order;
- ``gpt_tiny``'s logits under AMP: max |diff| <= 1.6e-2 of the largest
  |logit| (two bf16 steps of it); per-sample losses rtol 1.6e-2;
- gradients under AMP (fp32, through the casts): max |diff| <= 3e-2 of each
  gradient's largest entry: bf16's unit roundoff is 3.9e-3 and the two
  packages round a chain of bf16 products and activations in another
  order, over two layers and back;
- twin models trained under AMP (AdamW, epsilon 1e-4): per-sample losses
  rtol 1.6e-2 at every step; weights within 2 lr a step at most (an entry
  whose gradient is bf16 rounding noise, such as the key bias, whose
  gradient is zero in exact arithmetic, takes Adam steps of either sign in
  either package), and within 0.02 lr a step on average (the bulk agrees);
- multi-precision AdamW on a converted block: the fp32 masters as the twin
  weights above; each bf16 weight is its master rounded, exactly;
- the compiled step under AMP against the eager step under AMP: rtol 1e-6
  (one body of torch ops; it comes out bit-equal on the CPU);
- loss scaling under float16 on a Dense net: gradients max |diff| <= 2e-3
  of the largest entry (fp16's unit roundoff is 4.9e-4; one product).

Tests marked ``cuda`` run the bf16 path on the card; they skip without one.
The JAX package is imported inside the tests that use it, so
``pytest --noconftest tests/test_torch_amp.py -m cuda`` collects this file
on a machine without JAX.
"""
import threading

import numpy as onp
import pytest
import torch

from torch_parity import VOCAB, numpy_weights, twin_gpt

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.gluon.model_zoo import gpt_tiny
from mxnet_tpu_torch.ops import cuda_kernels as tk
from mxnet_tpu_torch.ops import nn as tnn

BF16_RTOL = 1.6e-2         # two bf16 steps of a value
GRAD_RTOL = 3e-2
ADAMW = {"learning_rate": 2e-3, "wd": 0.05, "epsilon": 1e-4}


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _nd(a):
    from mxnet_tpu.ndarray.ndarray import NDArray

    return NDArray(onp.asarray(a))


def _np(x):
    """A JAX NDArray or a torch tensor as a float32 numpy array, beside its
    dtype name."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy(), str(x.dtype).replace("torch.", "")
    a = x.asnumpy()
    return a.astype("float32"), a.dtype.name


@pytest.fixture(autouse=True)
def _amp_state_restored():
    """Each test leaves the thread's AMP state as it found it."""
    with tamp._scoped(tamp._snapshot()):
        yield


def _batch(rs, B=3, T=12, pad=True):
    toks = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    tgt = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    vl = onp.full((B,), T, "int32")
    if pad:
        vl[1] = T - 5          # one row right-padded
    return toks, vl, tgt


# -- the API ------------------------------------------------------------------
def test_lists_equal_the_reference():
    from mxnet_tpu import amp as jamp

    assert tamp.MXU_FUNCS == jamp.MXU_FUNCS
    assert tamp.FP32_FUNCS == jamp.FP32_FUNCS
    assert tamp.AMP_DTYPES == jamp.AMP_DTYPES
    assert tamp.MXU_OPS == jamp.MXU_OPS and tamp.FP32_OPS == jamp.FP32_OPS
    for name in ("init", "disable", "is_enabled", "target_dtype",
                 "resolve_dtype", "autocast", "attach_loss_scaler",
                 "scale_loss", "unscale", "convert_hybrid_block",
                 "convert_model", "LossScaler", "StaticLossScaler",
                 "DynamicLossScaler"):
        assert hasattr(tamp, name), name
    with pytest.raises(NotImplementedError):
        tamp.convert_model(None)


@pytest.mark.parametrize("name", ["bfloat16", "float16", "float8_e4m3",
                                  "float8_e4m3fn", "float8_e5m2", "int8",
                                  "bfloat17", "float32"])
def test_resolve_dtype_matches_reference(name):
    from mxnet_tpu import amp as jamp

    try:
        want = jamp.resolve_dtype(name)
    except ValueError:
        with pytest.raises(ValueError, match="target_dtype"):
            tamp.resolve_dtype(name)
        with pytest.raises(ValueError):
            tamp.init(name)
        return
    assert tamp.resolve_dtype(name) == want
    assert tamp.autocast(name).dtype == want


def test_init_autocast_nest_restore_and_are_thread_local():
    tamp.disable()
    assert not tamp.is_enabled()
    tamp.init("float16")
    assert tamp.is_enabled() and tamp.target_dtype() == "float16"
    with pytest.raises(ValueError):
        tamp.init("int8")              # validated before the state moves
    assert tamp.target_dtype() == "float16"
    with tamp.autocast("bfloat16"):
        assert tamp.target_dtype() == "bfloat16"
        with tamp.autocast("float8_e4m3"):
            assert tamp.target_dtype() == "float8_e4m3fn"
        assert tamp.target_dtype() == "bfloat16"
        seen = {}

        def other():
            seen["state"] = (tamp.is_enabled(), tamp.target_dtype())

        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        assert seen["state"] == (False, "bfloat16")   # a fresh thread: off
    assert tamp.is_enabled() and tamp.target_dtype() == "float16"
    tamp.disable()
    with tamp.autocast():
        assert tamp.is_enabled()
    assert not tamp.is_enabled()


# -- the cast at the op -------------------------------------------------------
def _op_case(case, rng):
    """(port call, reference (op name, inputs, attrs)) of one MXU op case."""
    if case == "fully_connected":
        x, w, b = (rng.randn(3, 5, 16).astype("float32"),
                   rng.randn(8, 16).astype("float32"),
                   rng.randn(8).astype("float32"))
        return (lambda: tnn.fully_connected(_t(x), _t(w), _t(b),
                                            flatten=False),
                ("fully_connected", [x, w, b],
                 {"num_hidden": 8, "flatten": False}))
    if case == "matmul":
        a, b = (rng.randn(2, 6, 16).astype("float32"),
                rng.randn(16, 9).astype("float32"))
        return (lambda: tnn.matmul(_t(a), _t(b)), ("matmul", [a, b], {}))
    if case.startswith("multihead_attention"):
        q, k, v = (rng.randn(2, 8, 32).astype("float32") for _ in range(3))
        ins = [q, k, v]
        mask = None
        if case.endswith("mask"):
            mask = onp.ones((2, 1, 1, 8), bool)
            mask[1, ..., 5:] = False
            ins.append(mask)
        return (lambda: tnn.multihead_attention(
                    _t(q), _t(k), _t(v),
                    mask=None if mask is None else _t(mask), num_heads=2,
                    causal=True),
                ("multihead_attention", ins, {"num_heads": 2,
                                              "causal": True}))
    q, k, v = (rng.randn(2, 2, 8, 16).astype("float32") for _ in range(3))
    seg = onp.ones((2, 8), "int32")
    seg[0, 6:] = 0
    return (lambda: tnn.flash_attention(_t(q), _t(k), _t(v), _t(seg),
                                        causal=True),
            ("flash_attention", [q, k, v, seg], {"causal": True}))


@pytest.mark.parametrize("case", ["fully_connected", "matmul",
                                  "multihead_attention",
                                  "multihead_attention_mask",
                                  "flash_attention"])
def test_mxu_ops_cast_as_the_reference(case):
    """Each MXU op of the port under ``autocast`` against the reference's
    ``apply_op`` under ``mxnet_tpu.amp.autocast``: output dtype, value;
    with AMP off both stay fp32."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.ops import apply_op

    port, (name, ins, attrs) = _op_case(case, onp.random.RandomState(3))
    assert name in tamp.MXU_OPS
    with jamp.autocast("bfloat16"):
        want, want_dt = _np(apply_op(name, *[_nd(a) for a in ins], **attrs))
    with tamp.autocast("bfloat16"):
        got, got_dt = _np(port())
    assert got_dt == want_dt == "bfloat16"
    bound = BF16_RTOL * onp.abs(want) + BF16_RTOL * onp.abs(want).max() / 8
    assert (onp.abs(got - want) <= bound).all(), \
        float(onp.abs(got - want).max())
    off, off_dt = _np(port())
    assert off_dt == "float32"


@pytest.mark.parametrize("name", ["layer_norm", "softmax", "log_softmax"])
def test_fp32_ops_keep_fp32_under_amp(name):
    """Ops of FP32_FUNCS get no cast: an fp32 input stays fp32 under
    ``autocast``, in both packages; a bf16 input stays bf16 (no upcast)."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.ops import apply_op

    rng = onp.random.RandomState(4)
    x = rng.randn(4, 16).astype("float32")
    g, b = onp.ones(16, "float32"), onp.zeros(16, "float32")
    args = [x, g, b] if name == "layer_norm" else [x]
    fn = getattr(tnn, name)
    assert name in tamp.FP32_OPS and name not in tamp.MXU_OPS
    with jamp.autocast("bfloat16"):
        _, want_dt = _np(apply_op(name, *[_nd(a) for a in args]))
    with tamp.autocast("bfloat16"):
        _, got_dt = _np(fn(*[_t(a) for a in args]))
        _, low_dt = _np(fn(_t(x).bfloat16(), *[_t(a) for a in args[1:]]))
    assert got_dt == want_dt == "float32"
    assert low_dt == "bfloat16"


# -- gpt_tiny under AMP -------------------------------------------------------
def _amp_forward_backward(jnet, tnet, toks, vl, tgt):
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.gluon import loss as jloss

    with jamp.autocast("bfloat16"):
        with mx.autograd.record():
            jlog = jnet(_nd(toks), _nd(vl))
            jl = jloss.SoftmaxCrossEntropyLoss()(jlog, _nd(tgt))
        jl.backward()
    with tamp.autocast("bfloat16"):
        with tag.record():
            tlog = tnet(_t(toks), _t(vl))
            tl = tloss.SoftmaxCrossEntropyLoss()(tlog, _t(tgt))
        tag.backward(tl)
    return (jlog, jl), (tlog, tl)


def test_gpt_tiny_forward_loss_and_gradients_match_reference_under_amp():
    jnet, tnet = twin_gpt(seed=11)
    (jlog, jl), (tlog, tl) = _amp_forward_backward(
        jnet, tnet, *_batch(onp.random.RandomState(2)))
    want, want_dt = _np(jlog)
    got, got_dt = _np(tlog)
    assert got_dt == want_dt == "bfloat16"
    assert float(onp.abs(got - want).max()) <= \
        BF16_RTOL * float(onp.abs(want).max())
    lw, lw_dt = _np(jl)
    lg, lg_dt = _np(tl)
    assert lg_dt == lw_dt == "bfloat16"
    onp.testing.assert_allclose(lg, lw, rtol=BF16_RTOL)
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        want = jp[n].grad().asnumpy()
        assert p.dtype == p.grad.dtype == torch.float32, n
        worst = float(onp.abs(p.grad.numpy() - want).max())
        assert worst <= GRAD_RTOL * float(onp.abs(want).max()), (n, worst)


def _weights_track(jnet, tnet, lr_steps):
    """Max and mean |diff| of every weight against 2 lr and 0.02 lr a
    step."""
    diffs = []
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        want = jp[n].data().asnumpy().astype("float32")
        d = onp.abs(p.detach().float().numpy() - want)
        assert float(d.max()) <= 2 * lr_steps, (n, float(d.max()))
        diffs.append(d.ravel())
    mean = float(onp.concatenate(diffs).mean())
    assert mean <= 0.02 * lr_steps, mean


def test_twin_gpt_trains_under_amp_as_the_reference():
    """Five AdamW steps of twin gpt_tiny models under AMP, one batch with a
    right-padded row: the losses and weights track (see the module
    docstring)."""
    import mxnet_tpu as mx

    jnet, tnet = twin_gpt(seed=14)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(ADAMW))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(ADAMW))
    rs = onp.random.RandomState(8)
    for s in range(5):
        toks, vl, tgt = _batch(rs, pad=s == 1)
        (_, jl), (_, tl) = _amp_forward_backward(jnet, tnet, toks, vl, tgt)
        jtr.step(toks.shape[0])
        ttr.step(toks.shape[0])
        onp.testing.assert_allclose(_np(tl)[0], _np(jl)[0], rtol=BF16_RTOL,
                                    err_msg=f"step {s}")
        _weights_track(jnet, tnet, ADAMW["learning_rate"] * (s + 1))
    assert ttr.optimizer.num_update == 5


def test_convert_hybrid_block_and_multi_precision_adamw_match_reference():
    """``convert_hybrid_block`` gives each parameter the reference's dtype
    (norm parameters fp32, the rest bf16); three multi-precision AdamW
    steps keep fp32 masters that track the reference's, and each bf16
    weight is its master rounded."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    jnet, tnet = twin_gpt(seed=14)
    assert jamp.convert_hybrid_block(jnet) is jnet
    assert tamp.convert_hybrid_block(tnet) is tnet
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        assert str(p.dtype).replace("torch.", "") == str(jp[n].data().dtype)
        if p.dtype == torch.bfloat16:          # cast: a zero bf16 gradient
            assert p.grad.dtype == p.dtype and not p.grad.any(), n
    assert tnet.ln_f.gamma.dtype == torch.float32
    assert tnet.tok_embed.weight.dtype == torch.bfloat16
    params = dict(ADAMW, multi_precision=True)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(params))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(params))
    rs = onp.random.RandomState(8)
    lr = ADAMW["learning_rate"]
    for s in range(3):
        toks, vl, tgt = _batch(rs, pad=s == 1)
        (_, jl), (_, tl) = _amp_forward_backward(jnet, tnet, toks, vl, tgt)
        jtr.step(toks.shape[0])
        ttr.step(toks.shape[0])
        onp.testing.assert_allclose(_np(tl)[0], _np(jl)[0], rtol=BF16_RTOL,
                                    err_msg=f"step {s}")
        masters = []
        for i, (n, p) in enumerate(tnet.collect_params().items()):
            js, ts = jtr._states[i], ttr._states[i]
            assert set(js) == set(ts), n
            if p.dtype != torch.bfloat16:
                assert "weight_fp32" not in ts, n
                continue
            m = ts["weight_fp32"]
            assert m.dtype == torch.float32
            assert torch.equal(p.detach(), m.to(torch.bfloat16)), n
            d = onp.abs(m.numpy() - js["weight_fp32"].asnumpy())
            assert float(d.max()) <= 2 * lr * (s + 1), (n, float(d.max()))
            masters.append(d.ravel())
        mean = float(onp.concatenate(masters).mean())
        assert mean <= 0.02 * lr * (s + 1), mean


def test_params_from_reference_bf16_block():
    """A converted reference block's bf16 arrays cross into a converted
    port block unchanged."""
    from mxnet_tpu import amp as jamp

    from mxnet_tpu_torch import params_from_mxnet_tpu

    jnet, tnet = twin_gpt(seed=15)
    jamp.convert_hybrid_block(jnet)
    tamp.convert_hybrid_block(tnet)
    arrays = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    assert arrays["tok_embed.weight"].dtype.name == "bfloat16"
    out = params_from_mxnet_tpu(arrays, tnet)
    for n, t in out.items():
        assert t.dtype == tnet.collect_params()[n].dtype, n
        onp.testing.assert_array_equal(t.float().numpy(),
                                       arrays[n].astype("float32"))


# -- loss scaling -------------------------------------------------------------
def _dense_twins(seed):
    import mxnet_tpu as mx
    from mxnet_tpu import np as mnp

    rs = onp.random.RandomState(seed)
    w = (rs.randn(4, 8) / 4).astype("float32")
    b = (rs.randn(4) / 4).astype("float32")
    jnet = mx.gluon.nn.Dense(4, in_units=8)
    jnet.initialize()
    jnet.weight.set_data(mnp.array(w))
    jnet.bias.set_data(mnp.array(b))
    tnet = tgnn.Dense(4, in_units=8, device="cpu")
    with torch.no_grad():
        tnet.weight.copy_(_t(w))
        tnet.bias.copy_(_t(b))
    return jnet, tnet


def test_scale_loss_and_unscale_match_reference_under_float16():
    """Under float16 the loss is multiplied by the attached scaler's scale
    and ``unscale`` divides the gradients back, as in the reference."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.gluon import loss as jloss

    jnet, tnet = _dense_twins(5)
    rs = onp.random.RandomState(6)
    x = rs.randn(3, 8).astype("float32")
    y = rs.randn(3, 4).astype("float32")
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    ttr = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.1})
    jamp.attach_loss_scaler(jtr, jamp.StaticLossScaler(2.0 ** 10))
    tamp.attach_loss_scaler(ttr, tamp.StaticLossScaler(2.0 ** 10))
    with jamp.autocast("float16"):
        with mx.autograd.record():
            jout = jnet(_nd(x))
            jl = jloss.L2Loss()(jout, _nd(y))
            with jamp.scale_loss(jl, jtr) as jscaled:
                pass
        jscaled.backward()
        jamp.unscale(jtr)
    with tamp.autocast("float16"):
        with tag.record():
            tout = tnet(_t(x))
            tl = tloss.L2Loss()(tout, _t(y))
            with tamp.scale_loss(tl, ttr) as tscaled:
                pass
        tag.backward(tscaled)
        tamp.unscale(ttr)
    assert _np(tout)[1] == _np(jout)[1] == "float16"
    onp.testing.assert_allclose(_np(tscaled)[0], _np(jscaled)[0], rtol=2e-3)
    onp.testing.assert_allclose(_np(tscaled)[0], _np(tl)[0] * 2 ** 10,
                                rtol=1e-6)
    for n, jp in (("weight", jnet.weight), ("bias", jnet.bias)):
        want = jp.grad().asnumpy()
        got = getattr(tnet, n).grad.numpy()
        assert float(onp.abs(got - want).max()) <= \
            2e-3 * float(onp.abs(want).max()), n
    # no scaler attached: scale_loss attaches the default one
    fresh = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.1})
    with tamp.autocast("float16"):
        with tamp.scale_loss(tl, fresh) as s2:
            pass
    assert isinstance(fresh._amp_loss_scaler, tamp.DynamicLossScaler)
    assert fresh._amp_loss_scaler.loss_scale == 2.0 ** 16
    onp.testing.assert_allclose(_np(s2)[0], _np(tl)[0] * 2 ** 16, rtol=1e-6)


def test_scale_loss_and_unscale_are_no_ops_under_bf16():
    _, tnet = _dense_twins(7)
    tr = Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.1})
    x = _t(onp.random.RandomState(8).randn(3, 8).astype("float32"))
    with tamp.autocast("bfloat16"):
        with tag.record():
            loss = tnet(x).float().square().mean(dim=1)
            with tamp.scale_loss(loss, tr) as scaled:
                assert scaled is loss
        tag.backward(scaled)
    assert not hasattr(tr, "_amp_loss_scaler")
    before = tnet.weight.grad.clone()
    tamp.unscale(tr)                       # no scaler: nothing to divide
    assert torch.equal(tnet.weight.grad, before)


# -- the compiled step under AMP ----------------------------------------------
def _twin_ports(seed, device="cpu", n=2, **kw):
    cfg = dict(vocab_size=VOCAB, dropout=0.0, num_layers=2, units=64,
               num_heads=4, max_length=64)
    cfg.update(kw)
    nets = []
    for _ in range(n):
        net = gpt_tiny(device=device, **cfg)
        net.load_dict(numpy_weights(
            {k: tuple(p.shape) for k, p in net.collect_params().items()},
            seed))
        nets.append(net)
    return nets


def _batches(seed, n, B=3, T=12):
    rs = onp.random.RandomState(seed)
    return [(_t(rs.randint(1, VOCAB, size=(B, T)).astype("int32")),
             _t(rs.randint(1, VOCAB, size=(B, T)).astype("int32")))
            for _ in range(n)]


def _eager_amp_step(net, tr, loss_fn, x, y):
    with tamp.autocast("bfloat16"):
        with tag.record():
            loss = loss_fn(net(x), y).mean()
        tag.backward(loss)
    tr.step(1)
    return loss.detach()


def test_compiled_step_under_amp_matches_eager_and_keeps_its_state():
    """The compiled step built under ``autocast`` against the eager AMP
    step on twin models: the first call inside ``autocast``, the rest
    outside it, as the reference's program keeps the AMP state of its
    first trace."""
    a, b = _twin_ports(seed=30)
    loss_fn = tloss.SoftmaxCELoss()
    ta = Trainer(a.collect_params(), "adamw", dict(ADAMW))
    tb = Trainer(b.collect_params(), "adamw", dict(ADAMW))
    step = ta.compile_step(a, loss_fn)
    for i, (x, y) in enumerate(_batches(31, 4)):
        if i == 0:
            with tamp.autocast("bfloat16"):
                lc = step(x, y)
        else:
            assert not tamp.is_enabled()
            lc = step(x, y)
        le = _eager_amp_step(b, tb, loss_fn, x, y)
        assert le.dtype == torch.bfloat16
        torch.testing.assert_close(lc, le.float(), rtol=1e-6, atol=0)
        for (n, p), q in zip(a.collect_params().items(),
                             b.collect_params().values()):
            torch.testing.assert_close(p, q, rtol=1e-6, atol=0,
                                       msg=f"{n} step {i}")
    assert step._traces == 1
    assert next(iter(step._cache.values())).amp_state == (True, "bfloat16")


def test_cast_between_calls_makes_the_compiled_step_capture_anew():
    (net,) = _twin_ports(seed=32, n=1)
    tr = Trainer(net.collect_params(), "adamw", dict(ADAMW))
    step = tr.compile_step(net, tloss.SoftmaxCELoss())
    batches = _batches(33, 3)
    step(*batches[0])
    step(*batches[1])
    assert step._traces == 1
    tamp.convert_hybrid_block(net)
    assert net.blocks[0].ffn_1.weight.dtype == torch.bfloat16
    loss = step(*batches[2])
    assert step._traces == 2
    assert torch.isfinite(loss).all()
    assert net.blocks[0].ffn_1.weight.dtype == torch.bfloat16
    assert net.ln_f.gamma.dtype == torch.float32
    net.cast("float32")
    step(*batches[0])
    assert step._traces == 3
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_block_and_parameter_cast():
    net = tgnn.Dense(3, in_units=4, device="cpu")
    with tag.record():
        y = net(torch.randn(2, 4)).sum()
    tag.backward(y)
    assert net.weight.grad.abs().sum() > 0
    weight = net.weight
    net.cast("bfloat16")
    assert net.weight is weight                # the same object
    assert weight.dtype == weight.grad.dtype == torch.bfloat16
    assert not weight.grad.any()
    with tag.record():
        y = net(torch.randn(2, 4).bfloat16()).sum()
    tag.backward(y)
    assert weight.grad.dtype == torch.bfloat16 and weight.grad.any()
    weight.grad_req = "null"
    weight.cast(torch.float32)
    assert weight.dtype == torch.float32 and weight.grad is None


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_amp_step_on_card_dtypes_kernels_and_cpu_gradients(cuda):
    """One AMP step of gpt_tiny on the card (one row right-padded): logits
    and loss bf16, gradients fp32 within 3e-2 of each largest entry of the
    same step on the CPU; the flash kernels ran their bf16 instances,
    LayerNorm its fp32 one."""
    dev_net, cpu_net = _twin_ports(seed=34, n=1, device=cuda) + \
        _twin_ports(seed=34, n=1)
    toks, vl, tgt = _batch(onp.random.RandomState(9))
    tk.reset_launch_counts()
    for net in (dev_net, cpu_net):
        d = next(net.parameters()).device
        with tamp.autocast("bfloat16"):
            with tag.record():
                logits = net(_t(toks).to(d), _t(vl).to(d))
                loss = tloss.SoftmaxCELoss()(logits, _t(tgt).to(d))
            tag.backward(loss)
        assert logits.dtype == loss.dtype == torch.bfloat16
    dts = tk.dtype_counts()
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        assert dts == {**dts, (k, ("bfloat16",)): 2}, dts
    assert dts[("layer_norm", ("float32", "float32"))] == 5
    cpu_params = cpu_net.collect_params()
    for n, p in dev_net.collect_params().items():
        want = cpu_params[n].grad
        assert p.grad.dtype == torch.float32, n
        worst = float((p.grad.cpu() - want).abs().max())
        assert worst <= GRAD_RTOL * float(want.abs().max()), (n, worst)


@pytest.mark.cuda
def test_converted_block_runs_bf16_layer_norm_on_card(cuda):
    (net,) = _twin_ports(seed=35, n=1, device=cuda)
    tamp.convert_hybrid_block(net)
    tr = Trainer(net.collect_params(), "adamw",
                 dict(ADAMW, multi_precision=True))
    x, y = (t.to(cuda) for t in _batches(36, 1)[0])
    tk.reset_launch_counts()
    with tag.record():
        loss = tloss.SoftmaxCELoss()(net(x), y)
    tag.backward(loss)
    tr.step(x.shape[0])
    assert tk.dtype_counts()[("layer_norm", ("bfloat16", "float32"))] == 5
    assert net.ln_f.gamma.grad.dtype == torch.float32
    assert all(st is None or "weight_fp32" not in st or
               st["weight_fp32"].dtype == torch.float32 for st in tr._states)


@pytest.mark.cuda
def test_float16_raises_in_the_kernels_on_card(cuda):
    """What no kernel instance takes raises, and float16 no longer does.

    Raises: operands of mixed dtypes, LayerNorm with float16 x and bfloat16
    gamma/beta, an fp8 softmax. Runs: the float16 flash instance through
    an op under ``autocast("float16")`` (every float16 instance is held to
    its plain version in ``tests/test_torch_amp16.py``)."""
    q = torch.randn(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(MXNetError, match="must share one of"):
        tk.flash_fwd_cuda(q, q.float(), q, None, None, 0.125, True)
    x = torch.randn(4, 64, device=cuda, dtype=torch.float16)
    g = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="unsupported dtypes"):
        tk.layer_norm_cuda(x, g, g, 1e-5)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tk.softmax_cuda(x.to(torch.float8_e4m3fn))
    qf = q.float()
    tk.reset_launch_counts()
    with tamp.autocast("float16"):
        out = tnn.flash_attention(qf, qf, qf, causal=True)
    assert out.dtype == torch.float16
    assert tk.dtype_counts() == {("flash_fwd", ("float16",)): 1}
