"""PyTorch/CUDA port: float16 and fp8 AMP against the JAX package.

The kernels' plain versions at float16, float8_e4m3fn and float8_e5m2, a
GPT under ``amp.autocast("float16")`` with its loss scaler, the decode
engine under AMP, bf16 graphs exported by one package and read by the
other, and the float8_e4m3fn cast (NaN past its range, as XLA's), each on
the same numpy inputs through both packages on the CPU. Tolerances, each
with its reason (u is a format's unit roundoff: 2^-11 for float16, 2^-8
for bfloat16, 2^-4 for float8_e4m3fn, 2^-3 for float8_e5m2):

- a flash kernel or plain version against the reference's: the limits of
  ``tests/torch_flash_limits.py`` (both sides round one value to the
  format, plus each element's own bound on how far the two values may lie
  apart before that rounding, from what it is summed from); the forward
  held to the plain version with the reference kernel's roundings
  (``attention_tiled_plain``), the reference formula's plain version to
  the reference's ``_attention_reference``;
- any other low-precision output against the other package's (the
  gradients through the flash op under autocast, LayerNorm, softmax):
  |diff| <= 4u (|want| + max |want| / 8) element by element: both sides
  round one fp32 value to the format (one step each, 2u of the value),
  and the second term covers values near zero, whose difference is a step
  of the larger values they are computed with;
- LayerNorm with float16 gamma/beta: 8u instead of 4u: the plain version
  is the reference's formula in x's dtype, five roundings in a chain
  ((x - mean), rsqrt, two products, the sum), where the kernels round one
  fp32 value;
- the fp32 log-sum-exp: 1e-4 (exact products of the rounded inputs, summed
  in fp32 in another order);
- ``gpt_tiny`` under float16 AMP: logits within 4u of the largest, losses
  rtol 4u, fp32 gradients within 8e-3 of each largest entry (a chain of
  fp16 products and activations rounded in another order over two layers
  and back); twin models trained under it: per-step losses rtol 4u, weights
  within 2 lr a step (the key bias, whose gradient is rounding noise, takes
  Adam steps of either sign) and 0.02 lr a step on average;
- greedy tokens: equal up to the first step whose top-2 margin (the port's
  full forward under the same AMP state) is below 4 steps of the format at
  the largest logit: a nearer tie may fall either way.

Tests marked ``cuda`` hold each new kernel instance to its plain version on
the card at every legal tile; they skip without one. The JAX package is
imported inside the tests that use it, so ``pytest --noconftest
tests/test_torch_amp16.py -m cuda`` collects this file on a machine
without JAX.
"""
import json

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.base import cast
from mxnet_tpu_torch.ops import cuda_kernels as tk

import torch_flash_limits as fl

LOW = ["float16", "float8_e4m3fn", "float8_e5m2"]
U = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8,
     "float8_e4m3fn": 2.0 ** -4, "float8_e5m2": 2.0 ** -3,
     "float32": 2.0 ** -24}


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _tt(a, dtype):
    """A float32 numpy array as a torch tensor of ``dtype`` (a name), cast
    as XLA casts."""
    return cast(_t(onp.asarray(a, "float32")), dtype)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return onp.asarray(x).astype("float32")


def _assert_low(got, want, dtype, what="", steps=4):
    """|got - want| <= steps u (|want| + max |want| / 8), elementwise."""
    g, w = _np32(got), _np32(want)
    bound = steps * U[dtype] * (onp.abs(w) + onp.abs(w).max() / 8)
    diff = onp.abs(g - w)
    assert (diff <= bound).all(), (what, float(diff.max()),
                                   float((diff - bound).max()))


def _qkv(rng, B, H, Tq, Tk, D):
    return (rng.randn(B, H, Tq, D).astype("float32"),
            rng.randn(B, H, Tk, D).astype("float32"),
            rng.randn(B, H, Tk, D).astype("float32"))


@pytest.fixture(autouse=True)
def _amp_state_restored():
    with tamp._scoped(tamp._snapshot()):
        yield


# -- the plain flash versions against the Pallas kernels (interpret mode) ----
def _pallas_flash(dtype, causal, block):
    """The Pallas forward and backward kernels in interpret mode as
    ``fwd(q, k, v, q_seg, k_seg)`` and ``bwd(q, k, v, out, lse, g, q_seg,
    k_seg)`` over the port's tensors (scale 1/8, tiles ``block``)."""
    import jax.numpy as jnp

    from mxnet_tpu.ops import pallas_kernels as pk

    def j(t):
        return None if t is None else jnp.asarray(_np32(t)).astype(
            str(t.dtype).replace("torch.", ""))

    def fwd(q, k, v, qs, ks):
        o, lse = pk._flash_attention_tpu(
            j(q), j(k), j(v), 1 / 8, causal, block, block, return_lse=True,
            q_seg=j(qs), k_seg=j(ks))
        return _tt(onp.asarray(o.astype("float32")), dtype), \
            _t(onp.array(lse))

    def bwd(q, k, v, out, lse, g, qs, ks):
        grads = pk._flash_bwd_tpu(j(q), j(k), j(v), j(out), j(lse), j(g),
                                  1 / 8, causal, block, block, q_seg=j(qs),
                                  k_seg=j(ks))
        return [_tt(onp.asarray(t.astype("float32")), dtype) for t in grads]

    return fwd, bwd


@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("causal,seg", [(True, False), (False, True)])
def test_flash_plain_matches_pallas_kernels(monkeypatch, dtype, causal,
                                            seg):
    """Forward (out, lse) and backward (dq, dk, dv) of the Pallas kernels,
    run in interpret mode on the same rounded inputs, against the plain
    versions: the forward against ``attention_tiled_plain`` at the kernel's
    key tile, the backward against ``attention_bwd_plain`` from the
    kernel's out and lse (Δ = rowsum(g out) cancels against g v^T in ds, so
    a one-step difference of out would show in dq at a step of the
    operands, not of dq), within the limits of ``torch_flash_limits``;
    outputs and gradients in the operands' dtype, as the reference's."""
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    rng = onp.random.RandomState(3)
    B, H, T, D = 2, 1, 128, 64
    tq, tk_, tv, tg = (_tt(a, dtype) for a in (*_qkv(rng, B, H, T, T, D),
                                                rng.randn(B, H, T, D)))
    tids = None
    if seg:
        ids = onp.ones((B, T), "int32")
        ids[1, 90:] = 0
        tids = _t(ids)
    fwd, bwd = _pallas_flash(dtype, causal, 64)
    out, lse = fwd(tq, tk_, tv, tids, tids)
    grads = bwd(tq, tk_, tv, out, lse, tg, tids, tids)
    ex = fl.flash_excess(tq, tk_, tv, tg, out, lse, grads, tids, tids,
                         1 / 8, causal, 64, dtype)
    assert max(ex["out"], ex["dq"], ex["dk"], ex["dv"]) <= 1.0, ex
    assert ex["lse"] <= 1e-4, ex
    plain, _ = tk.attention_plain(tq, tk_, tv, 1 / 8, causal, tids, tids)
    assert plain.dtype == out.dtype == grads[0].dtype == getattr(torch,
                                                                 dtype)


@pytest.mark.parametrize("dtype", LOW)
def test_flash_limits_catch_planted_faults(dtype):
    """The limits that hold the kernels to their plain versions fail a
    wrong kernel: a stand-in with the plain versions' values (causal,
    tile 32) with one key tile hidden, V's or G's row tiles in reverse
    order, or outputs zero past the first tile, each over its limit on
    every output the fault reaches (``torch_flash_limits.FAULT_HITS``);
    chip_smoke.py plants the same faults in the kernels."""
    rng = onp.random.RandomState(22)
    q, k, v, g = (_tt(rng.randn(1, 2, 256, 64), dtype) for _ in range(4))

    def fwd(q, k, v, qs, ks):
        return tk.attention_tiled_plain(q, k, v, 1 / 8, True, qs, ks, 32)

    def bwd(q, k, v, out, lse, g, qs, ks):
        return tk.attention_bwd_plain(q, k, v, out, lse, g, qs, ks, 1 / 8,
                                      True)

    res = fl.planted_faults(fwd, bwd, q, k, v, g, 1 / 8, True, 32, 32,
                            dtype)
    assert not fl.faults_missed(res), res


@pytest.mark.parametrize("dtype", LOW)
def test_flash_op_under_autocast_matches_reference(dtype):
    """The ``flash_attention`` op under ``autocast(dtype)`` on fp32
    operands (the reference's XLA path on the CPU): the output's dtype and
    values (both round the normalized p: the limit of
    ``torch_flash_limits`` with ``normalized=True``), and fp32 gradients
    through the casts."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.ops import apply_op

    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch.ops import nn as tnn

    rng = onp.random.RandomState(4)
    q, k, v = (rng.randn(2, 4, 96, 64).astype("float32") for _ in range(3))
    seg = onp.ones((2, 96), "int32")
    seg[0, 70:] = 0
    jins = [NDArray(a) for a in (q, k, v)]
    for a in jins:
        a.attach_grad()
    with jamp.autocast(dtype):
        with mx.autograd.record():
            jout = apply_op("flash_attention", *jins, NDArray(seg),
                            causal=True)
            jl = jout.astype("float32").sum()
        jl.backward()
    tins = [_t(a).requires_grad_() for a in (q, k, v)]
    with tamp.autocast(dtype):
        with tag.record():
            tout = tnn.flash_attention(*tins, _t(seg), causal=True)
        tout.float().sum().backward()
    assert str(tout.dtype) == f"torch.{dtype}" == \
        f"torch.{jout.asnumpy().dtype}"
    cq, ck_, cv = (cast(_t(a), dtype) for a in (q, k, v))
    tseg = _t(seg)
    delta = fl.forward_delta(cq, ck_, cv, 1 / 8, True, tseg, tseg, dtype,
                             normalized=True)
    ex = fl.excess(tout, _t(onp.asarray(jout.asnumpy(), "float32")), dtype,
                   delta)
    assert ex <= 1.0, ex
    for n, a, b in zip("qkv", tins, jins):
        assert a.grad.dtype == torch.float32
        _assert_low(a.grad, b.grad.asnumpy(), dtype, "d" + n)


@pytest.mark.parametrize("gdtype", ["float32", "float16"])
def test_layer_norm_plain_float16_matches_pallas_kernel(monkeypatch, gdtype):
    """x float16 with gamma/beta float32 (``convert_hybrid_block``'s norm
    layers) or float16: the output in x's dtype, as the reference's."""
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas_kernels import fused_layer_norm

    rng = onp.random.RandomState(5)
    x = (rng.randn(64, 256) * 3 + 1).astype("float32")
    gam = rng.randn(256).astype("float32")
    bet = rng.randn(256).astype("float32")
    want = fused_layer_norm(jnp.asarray(x, "float16"),
                            jnp.asarray(gam, gdtype),
                            jnp.asarray(bet, gdtype))
    got = tk.fused_layer_norm(_tt(x, "float16"), _tt(gam, gdtype),
                              _tt(bet, gdtype))
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    _assert_low(got, want, "float16", steps=4 if gdtype == "float32" else 8)


@pytest.mark.parametrize("d", [256, 100])
def test_softmax_plain_float16_matches_reference(monkeypatch, d):
    """Pallas (d = 256) or ``jax.nn.softmax`` (d = 100) at float16."""
    import jax.numpy as jnp

    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")
    from mxnet_tpu.ops.pallas_kernels import fused_softmax

    x = (onp.random.RandomState(6).randn(48, d) * 4).astype("float32")
    want = fused_softmax(jnp.asarray(x, "float16"))
    got = tk.fused_softmax(_tt(x, "float16"))
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    _assert_low(got, want, "float16")


# -- C14: the float8_e4m3fn cast, as XLA's -----------------------------------
_OVER = onp.array([1.0, 447.0, 460.0, 464.0, 464.5, 500.0, -1000.0, 7e4,
                   onp.inf, -onp.inf, 2.0 ** -10, -3.0], "float32")


def _cast_case(site, pkg, x, dtype):
    """x (float32 numpy) cast to ``dtype`` by one site of package ``pkg``
    (the JAX package's module or the port's); returns a float32 numpy
    array."""
    if site == "astype":
        return pkg.np.array(x).astype(dtype).astype("float32").asnumpy()
    if site == "npx_cast":
        return pkg.npx.cast(pkg.np.array(x), dtype).astype(
            "float32").asnumpy()
    if site == "amp_cast":
        return pkg.ops.apply_op("amp_cast", pkg.np.array(x),
                                dtype=dtype).astype("float32").asnumpy()
    if site == "array":
        return pkg.np.array(x, dtype=dtype).astype("float32").asnumpy()
    if site == "full":
        return pkg.np.full((2,), float(x[5]), dtype=dtype).astype(
            "float32").asnumpy()
    # an fp32 operand of an MXU op under autocast: the input is cast at the
    # op, so a row holding an overflow gives NaN (e4m3fn) or inf outputs
    w = onp.eye(len(x), dtype="float32")[:4]
    with pkg.amp.autocast(dtype):
        y = pkg.ops.apply_op("fully_connected", pkg.np.array(x[None]),
                             pkg.np.array(w), no_bias=True, num_hidden=4)
    return y.astype("float32").asnumpy()


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2",
                                   "float16"])
@pytest.mark.parametrize("site", ["astype", "npx_cast", "amp_cast", "array",
                                  "full", "autocast_op"])
def test_float_casts_give_xlas_result(site, dtype):
    """Every cast site of the port against the JAX package's on values
    about the formats' ends: float8_e4m3fn gives NaN past its range (|x| >
    464, and +-inf), where ``torch.Tensor.to`` saturates to +-448;
    float8_e5m2 and float16 give inf in both."""
    import mxnet_tpu as mx

    import mxnet_tpu_torch as tmx

    want = _cast_case(site, mx, _OVER, dtype)
    with tmx.cpu():
        got = _cast_case(site, tmx, _OVER, dtype)
    onp.testing.assert_array_equal(got, want)
    if dtype == "float8_e4m3fn" and site != "full":
        assert onp.isnan(got).any()


def test_e4m3_cast_of_parameters_and_gradients():
    """``Parameter.cast`` / ``convert_hybrid_block`` to float8_e4m3fn and the
    cast's gradient: an overflowing weight becomes NaN as in the
    reference; gradients come back in the source dtype."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    import mxnet_tpu_torch as tmx

    w = onp.array([[1.0, 500.0], [-470.0, 3.0]], "float32")
    jnet = mx.gluon.nn.Dense(2, in_units=2)
    jnet.initialize()
    jnet.weight.set_data(mx.np.array(w))
    jamp.convert_hybrid_block(jnet, "float8_e4m3fn")
    tnet = tmx.gluon.nn.Dense(2, in_units=2, device="cpu")
    tnet.initialize()
    with torch.no_grad():
        tnet.weight.copy_(_t(w))
    tamp.convert_hybrid_block(tnet, "float8_e4m3fn")
    want = jnet.weight.data().asnumpy().astype("float32")
    got = tnet.weight.detach().float().numpy()
    onp.testing.assert_array_equal(got, want)
    assert onp.isnan(got).sum() == 2
    x = _t(_OVER).requires_grad_()
    cast(x, "float8_e4m3fn").float().sum().backward()
    assert x.grad.dtype == torch.float32 and bool((x.grad == 1).all())


# -- GPT under float16 AMP ------------------------------------------------------
ADAMW = {"learning_rate": 2e-3, "wd": 0.05, "epsilon": 1e-4}
F16 = "float16"


def _nd(a):
    from mxnet_tpu.ndarray.ndarray import NDArray

    return NDArray(onp.asarray(a))


def _batch(rs, B=3, T=12, pad=True):
    from torch_parity import VOCAB

    toks = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    vl = onp.full((B,), T, "int32")
    if pad:
        vl[1] = T - 4
    tgt = rs.randint(1, VOCAB, size=(B, T)).astype("int32")
    return toks, vl, tgt


def _f16_forward(jnet, tnet, toks, vl, tgt, jtr=None, ttr=None):
    """One forward and backward of both twins under float16 AMP
    (``amp.init`` where trainers are given, else ``autocast``); with
    trainers, through ``scale_loss`` (the attached scalers). Returns
    ((logits, loss) JAX, (logits, loss) port)."""
    import contextlib

    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.gluon import loss as jloss

    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch.gluon import loss as tloss

    def scope(amp_mod):
        if jtr is None:
            return amp_mod.autocast(F16)
        amp_mod.init(F16)        # on until the end of the test
        return contextlib.nullcontext()

    with scope(jamp):
        with mx.autograd.record():
            jlog = jnet(_nd(toks), _nd(vl))
            jl = jloss.SoftmaxCrossEntropyLoss()(jlog, _nd(tgt))
            if jtr is not None:
                with jamp.scale_loss(jl, jtr) as js:
                    pass
        (jl if jtr is None else js).backward()
    with scope(tamp):
        with tag.record():
            tlog = tnet(_t(toks), _t(vl))
            tl = tloss.SoftmaxCrossEntropyLoss()(tlog, _t(tgt))
            if ttr is not None:
                with tamp.scale_loss(tl, ttr) as ts:
                    pass
        tag.backward(tl if ttr is None else ts)
    return (jlog, jl), (tlog, tl)


def _grads_close(jnet, tnet, rtol=8e-3):
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        want = jp[n].grad().asnumpy().astype("float32")
        assert p.grad.dtype == p.dtype, n
        worst = float(onp.abs(p.grad.float().numpy() - want).max())
        assert worst <= rtol * float(onp.abs(want).max()), (n, worst)


def _weights_track(jnet, tnet, lr_steps):
    diffs = []
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        want = jp[n].data().asnumpy().astype("float32")
        d = onp.abs(p.detach().float().numpy() - want)
        assert float(d.max()) <= 2 * lr_steps, (n, float(d.max()))
        diffs.append(d.ravel())
    mean = float(onp.concatenate(diffs).mean())
    assert mean <= 0.02 * lr_steps, mean


def test_gpt_tiny_under_float16_matches_reference():
    """Logits and loss float16, gradients of the fp32 parameters fp32, all
    within the module's float16 bounds of the reference's."""
    from torch_parity import twin_gpt

    jnet, tnet = twin_gpt(seed=11)
    (jlog, jl), (tlog, tl) = _f16_forward(
        jnet, tnet, *_batch(onp.random.RandomState(2)))
    assert tlog.dtype == tl.dtype == torch.float16
    assert str(jlog.asnumpy().dtype) == str(jl.asnumpy().dtype) == F16
    want = jlog.asnumpy().astype("float32")
    assert float(onp.abs(_np32(tlog) - want).max()) <= \
        4 * U[F16] * float(onp.abs(want).max())
    onp.testing.assert_allclose(_np32(tl), _np32(jl.asnumpy()),
                                rtol=4 * U[F16])
    _grads_close(jnet, tnet)


def _scaled_step(jnet, tnet, jtr, ttr, batch):
    """One step of the reference's float16 recipe in both packages:
    ``scale_loss``, backward, an overflow check on the scaled gradients
    (skip and halve), else ``unscale``, ``update_scale`` and the trainer's
    step. Returns (JAX skipped, port skipped, JAX loss, port loss)."""
    from mxnet_tpu import amp as jamp

    (_, jl), (_, tl) = _f16_forward(jnet, tnet, *batch, jtr, ttr)
    out = []
    for amp_mod, tr, params in (
            (jamp, jtr, jtr._params),
            (tamp, ttr, ttr._params)):
        sc = tr._amp_loss_scaler
        skip = sc.has_overflow(params)
        if skip:
            sc.update_scale(True)
        else:
            amp_mod.unscale(tr)
            sc.update_scale(False)
            tr.step(batch[0].shape[0])
        out.append(skip)
    return out[0], out[1], jl, tl


@pytest.fixture
def _ref_amp_restored():
    """The JAX package's thread-local AMP state as the test found it (the
    port's is restored for every test)."""
    from mxnet_tpu import amp as jamp

    was = (jamp.is_enabled(), jamp.target_dtype())
    yield
    if was[0]:
        jamp.init(was[1])
    else:
        jamp.disable()


def test_twin_gpt_float16_loss_scaler_skips_halves_and_grows(
        _ref_amp_restored):
    """Six steps of twin models under ``amp.init("float16")`` with a
    DynamicLossScaler (init_scale 2**16, scale_window 2): loss x 2**16 overflows float16, so
    both packages skip and halve until the scaled loss fits, then train,
    and the scale doubles after two clean steps. Skips, scales and
    num_update are equal; losses and weights track."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    from mxnet_tpu_torch.gluon import Trainer
    from torch_parity import twin_gpt

    jnet, tnet = twin_gpt(seed=14)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(ADAMW))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(ADAMW))
    jsc = jamp.attach_loss_scaler(
        jtr, jamp.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=2))
    tsc = tamp.attach_loss_scaler(
        ttr, tamp.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=2))
    rs = onp.random.RandomState(8)
    skips, scales, trained = [], [], 0
    for s in range(6):
        before = {n: p.detach().clone()
                  for n, p in tnet.collect_params().items()}
        jskip, tskip, jl, tl = _scaled_step(jnet, tnet, jtr, ttr,
                                            _batch(rs, pad=s == 1))
        assert jskip == tskip, s
        assert tsc.loss_scale == jsc.loss_scale, s
        skips.append(tskip)
        scales.append(tsc.loss_scale)
        onp.testing.assert_allclose(_np32(tl), _np32(jl.asnumpy()),
                                    rtol=4 * U[F16], err_msg=f"step {s}")
        if tskip:
            for n, p in tnet.collect_params().items():
                assert torch.equal(p.detach(), before[n]), (s, n)
        else:
            trained += 1
        assert ttr.optimizer.num_update == jtr.optimizer.num_update == \
            trained
        _weights_track(jnet, tnet, ADAMW["learning_rate"] * max(trained, 1))
    assert skips[0] and not all(skips), skips
    first = skips.index(False)
    assert scales[:first] == [2.0 ** (15 - i) for i in range(first)]
    assert max(scales[first:]) == 2 * scales[first - 1], scales


def test_compiled_float16_step_with_scaler_matches_reference():
    """The compiled step built under ``autocast(float16)`` with an attached
    DynamicLossScaler, in both packages: the same skips and scales, losses
    and weights tracking, one capture (program) in the port."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.gluon import loss as jloss

    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as tloss
    from torch_parity import twin_gpt

    jnet, tnet = twin_gpt(seed=24)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(ADAMW))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(ADAMW))
    jsc = jamp.attach_loss_scaler(
        jtr, jamp.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=2))
    tsc = tamp.attach_loss_scaler(
        ttr, tamp.DynamicLossScaler(init_scale=2.0 ** 16, scale_window=2))
    jstep = jtr.compile_step(jnet, jloss.SoftmaxCrossEntropyLoss())
    tstep = ttr.compile_step(tnet, tloss.SoftmaxCrossEntropyLoss())
    rs = onp.random.RandomState(7)
    scales = []
    for s in range(6):
        x, _, y = _batch(rs, pad=False)
        with jamp.autocast(F16):
            jl = jstep(_nd(x), _nd(y))
        with tamp.autocast(F16):
            tl = tstep(_t(x), _t(y))
        assert tsc.loss_scale == jsc.loss_scale, s
        scales.append(tsc.loss_scale)
        onp.testing.assert_allclose(_np32(tl), _np32(jl.asnumpy()),
                                    rtol=4 * U[F16], err_msg=f"step {s}")
        assert ttr.optimizer.num_update == jtr.optimizer.num_update
    # a skip halves the scale, two clean steps double it
    assert scales[0] == 2.0 ** 15 and 2.0 ** 16 in scales[1:], scales
    assert 0 < ttr.optimizer.num_update < len(scales)
    _weights_track(jnet, tnet,
                   ADAMW["learning_rate"] * ttr.optimizer.num_update)
    assert tstep._traces == 1
    assert next(iter(tstep._cache.values())).amp_state == (True, F16)


def test_convert_hybrid_block_float16_and_multi_precision_adamw():
    """``convert_hybrid_block(net, "float16")``: norm parameters stay fp32,
    the rest float16, as the reference's; two multi-precision AdamW steps
    keep fp32 masters that track the reference's, each float16 weight its
    master rounded."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu.gluon import loss as jloss
    from torch_parity import twin_gpt

    jnet, tnet = twin_gpt(seed=14)
    jamp.convert_hybrid_block(jnet, F16)
    tamp.convert_hybrid_block(tnet, F16)
    jp = jnet.collect_params()
    for n, p in tnet.collect_params().items():
        assert str(p.dtype).replace("torch.", "") == str(jp[n].data().dtype)
    assert tnet.ln_f.gamma.dtype == torch.float32
    assert tnet.blocks[0].ffn_1.weight.dtype == torch.float16
    params = dict(ADAMW, multi_precision=True)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(params))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(params))
    rs = onp.random.RandomState(8)
    lr = ADAMW["learning_rate"]
    for s in range(2):
        toks, vl, tgt = _batch(rs, pad=s == 1)
        with mx.autograd.record():
            jl = jloss.SoftmaxCrossEntropyLoss()(
                jnet(_nd(toks), _nd(vl)), _nd(tgt))
        jl.backward()
        with tag.record():
            tl = tloss.SoftmaxCrossEntropyLoss()(
                tnet(_t(toks), _t(vl)), _t(tgt))
        tag.backward(tl)
        assert tl.dtype == torch.float16
        jtr.step(toks.shape[0])
        ttr.step(toks.shape[0])
        onp.testing.assert_allclose(_np32(tl), _np32(jl.asnumpy()),
                                    rtol=4 * U[F16], err_msg=f"step {s}")
        masters = []
        for i, (n, p) in enumerate(tnet.collect_params().items()):
            if p.dtype != torch.float16:
                assert "weight_fp32" not in ttr._states[i], n
                continue
            m = ttr._states[i]["weight_fp32"]
            assert m.dtype == torch.float32
            assert torch.equal(p.detach(), m.to(torch.float16)), n
            d = onp.abs(m.numpy() -
                        jtr._states[i]["weight_fp32"].asnumpy())
            assert float(d.max()) <= 2 * lr * (s + 1), (n, float(d.max()))
            masters.append(d.ravel())
        assert float(onp.concatenate(masters).mean()) <= 0.02 * lr * (s + 1)


# -- the decode engine under AMP -------------------------------------------------
ENGINE = dict(num_slots=2, max_len=32, max_prompt_len=8, prefill_batch=1,
              page_tokens=8, prefix_cache=False)


def _assert_tokens_agree(tnet, dtype, prompt, got, want):
    """``got`` equals ``want`` up to the first step whose top-2 margin, from
    the port's full forward under ``autocast(dtype)`` (or as converted),
    is below four steps of the format at the largest logit."""
    seq = list(prompt) + list(want)
    with torch.no_grad(), tamp.autocast(dtype):
        logits = tnet(torch.tensor([seq], dtype=torch.int32))[0].float()
    steps = logits[len(prompt) - 1:len(seq) - 1]
    top = torch.topk(steps, 2, dim=-1).values
    near = 4 * U[dtype] * float(logits.abs().max()) * 2
    n = len(want)
    for i, m in enumerate((top[:, 0] - top[:, 1]).tolist()):
        if m < near:
            n = i
            break
    assert got[:n] == want[:n], (n, got, want)
    assert len(got) == len(want)


def _serve(eng, ps, n=6):
    streams = [eng.submit(p, max_new_tokens=n) for p in ps]
    return [s.result(timeout=120) for s in streams]


@pytest.mark.parametrize("mode", ["autocast:float16", "autocast:bfloat16",
                                  "convert:bfloat16"])
def test_decode_engine_under_amp_matches_reference(monkeypatch, mode):
    """A ``DecodeEngine`` built under ``autocast`` (its bodies run under
    that state on the engine's own thread) or over a converted model: the
    KV cache keeps the model's dtype (float32), as the reference's
    (programs.py:262-273); the prefill's attention runs at the AMP dtype;
    the tokens are the reference engine's, or, where the reference's engine
    cannot be built (bfloat16: its prefill asks ``one_hot`` for a dtype
    named by ``str(jnp.bfloat16)``, TypeError), its naive generation's."""
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp
    from mxnet_tpu.serve.decode import DecodeEngine as JaxDecodeEngine

    from mxnet_tpu_torch.serve.decode import DecodeEngine
    from torch_parity import prompts, twin_gpt

    how, dtype = mode.split(":")
    jnet, tnet = twin_gpt(seed=11)
    if how == "convert":
        jamp.convert_hybrid_block(jnet, dtype)
        tamp.convert_hybrid_block(tnet, dtype)
    scope = (lambda m: m.autocast(dtype)) if how == "autocast" else \
        (lambda m: tamp._scoped(tamp._snapshot()))
    seen = []
    plain = tk.attention_plain

    def spy(q, *a, **kw):
        seen.append(q.dtype)
        return plain(q, *a, **kw)

    monkeypatch.setattr(tk, "attention_plain", spy)
    with scope(tamp):
        teng = DecodeEngine(tnet, device="cpu", **ENGINE)
    ps = prompts(3, lo=2, hi=8, seed=3)
    try:
        got = _serve(teng, ps)
        assert teng.programs.cache_dtype == "float32"
    finally:
        teng.close()
    assert seen and set(seen) == {getattr(torch, dtype)}, set(seen)
    monkeypatch.setattr(tk, "attention_plain", plain)
    jeng = None
    if mode == "autocast:float16":
        with jamp.autocast(dtype):
            jeng = JaxDecodeEngine(jnet, cache_dir=False, **ENGINE)
    elif how == "autocast":
        with pytest.raises(TypeError, match="bfloat16"), \
                jamp.autocast(dtype):
            JaxDecodeEngine(jnet, cache_dir=False, **ENGINE)
    if jeng is not None:
        try:
            want = _serve(jeng, ps)
            assert jeng.programs.cache_dtype == "float32"
        finally:
            jeng.close()
    else:
        with (jamp.autocast(dtype) if how == "autocast" else
              tamp._scoped(tamp._snapshot())):
            want = [[int(t) for t in jnet.generate(
                p, max_new_tokens=6, temperature=0.0,
                use_cache=False)[len(p):]] for p in ps]
    with (tamp.autocast(dtype) if how == "autocast" else
          tamp._scoped(tamp._snapshot())):
        naive = [tnet.generate(p, max_new_tokens=6, use_cache=False)[len(p):]
                 for p in ps]
    for p, g, w, nv in zip(ps, got, want, naive):
        _assert_tokens_agree(tnet, dtype, p, g, w)
        _assert_tokens_agree(tnet, dtype, p, g, nv)


# -- bfloat16 graphs exported and imported ---------------------------------------
def _const_nets():
    """The same small graph in both packages: a Dense layer and a bfloat16
    constant added in the forward (a const node in the traced graph)."""
    import mxnet_tpu as mx

    import mxnet_tpu_torch as tmx

    c = [0.5, 1.5, -2.0, 3.25]

    class JNet(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = mx.gluon.nn.Dense(4, in_units=8)

        def forward(self, x):
            return self.dense(x) + mx.np.array(c, dtype="bfloat16")

    class TNet(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.dense = tmx.gluon.nn.Dense(4, in_units=8, device="cpu")

        def forward(self, x):
            return self.dense(x) + tmx.np.array(c, dtype="bfloat16",
                                                 ctx=tmx.cpu())

    return JNet, TNet


def _weights(seed):
    rs = onp.random.RandomState(seed)
    return (rs.randn(4, 8) / 3).astype("float32"), \
        (rs.randn(4) / 3).astype("float32")


def test_bf16_export_crosses_both_ways(tmp_path):
    """A converted (bfloat16) hybridized block with a bfloat16 constant,
    exported by each package and read by the other: the const node as a
    list of floats beside ``"dtype": "bfloat16"``, the parameters as the
    reference's ``np.savez`` writes them (``|V2`` raw bits); outputs equal.
    The reference cannot import a ``.params.npz`` with bfloat16 entries,
    its own or the port's (``SymbolBlock.imports`` raises TypeError on
    ``|V2``), so the port's file is checked by the reference's
    ``Symbol.load`` with the parameters' bits handed over by hand."""
    import ml_dtypes
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.gluon import SymbolBlock

    JNet, TNet = _const_nets()
    w, b = _weights(3)
    x = onp.random.RandomState(4).randn(2, 8).astype("float32")
    jnet = JNet()
    jnet.initialize()
    jnet.dense.weight.set_data(mx.np.array(w))
    jnet.dense.bias.set_data(mx.np.array(b))
    jamp.convert_hybrid_block(jnet, "bfloat16")
    jnet.hybridize()
    jx = mx.np.array(x).astype("bfloat16")
    want = jnet(jx).asnumpy().astype("float32")
    jsym, jparams = jnet.export(str(tmp_path / "ref"))
    consts = [n for n in json.load(open(jsym))["nodes"]
              if n["op"] == "_const"]
    assert consts and consts[0]["dtype"] == "bfloat16"
    with onp.load(jparams) as z:
        assert z["dense.weight"].dtype.str == "|V2"
    with pytest.raises(TypeError):
        mx.gluon.SymbolBlock.imports(jsym, ["data0"], jparams)(jx)
    # the reference's files, read by the port
    with tmx.cpu():
        blk = SymbolBlock.imports(jsym, ["data0"], jparams, ctx=tmx.cpu())
        tx = _tt(x, "bfloat16")
        got = blk(tx)
    assert got.dtype == torch.bfloat16
    onp.testing.assert_array_equal(_np32(got), want)
    # the port's files, read by the reference
    tnet = TNet()
    tnet.initialize()
    with torch.no_grad():
        tnet.dense.weight.copy_(_t(w))
        tnet.dense.bias.copy_(_t(b))
    tamp.convert_hybrid_block(tnet, "bfloat16")
    tnet.hybridize()
    onp.testing.assert_array_equal(_np32(tnet(tx)), want)
    tsym, tparams = tnet.export(str(tmp_path / "port"))
    tconsts = [n for n in json.load(open(tsym))["nodes"]
               if n["op"] == "_const"]
    assert [(n["dtype"], n["value"]) for n in tconsts] == \
        [(n["dtype"], n["value"]) for n in consts]
    with onp.load(tparams) as z:
        arrays = {k: z[k] for k in z.files}
    assert {a.dtype.str for a in arrays.values()} == {"|V2"}
    from mxnet_tpu.ndarray.ndarray import NDArray
    from mxnet_tpu.symbol.symbol import Symbol

    args = {k: NDArray(a.view(ml_dtypes.bfloat16))
            for k, a in arrays.items()}
    out = mx.gluon.SymbolBlock(Symbol.load(tsym), ["data0"], args)(jx)
    onp.testing.assert_array_equal(out.asnumpy().astype("float32"), want)
    # and the port reads its own files back
    with tmx.cpu():
        again = SymbolBlock.imports(tsym, ["data0"], tparams,
                                    ctx=tmx.cpu())
        onp.testing.assert_array_equal(_np32(again(tx)), want)


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _ragged_ids(B, T, dev):
    # padding ids on the second batch row and a query row that sees no key
    ks = onp.ones((B, T), "int32")
    ks[1, 70:] = 0
    qs = ks.copy()
    qs[0, 5] = 9
    return _t(qs).to(dev), _t(ks).to(dev)


def _on(a, dtype, dev):
    return _tt(a, dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("block_k", tk.FLASH_BLOCKS)
@pytest.mark.parametrize("block_q", tk.FLASH_BLOCKS)
def test_flash_instances_match_plain_at_every_tile_on_card(
        cuda, block_q, block_k, D, dtype):
    """Each new instance of the three flash kernels at every tile and
    head-dim class: ragged T = 100, causal, padding ids and a row that sees
    no key (exact zeros), within the limits of ``torch_flash_limits``."""
    rng = onp.random.RandomState(12)
    B, H, T = 2, 3, 100
    q, k, v = (_on(a, dtype, cuda) for a in _qkv(rng, B, H, T, T, D))
    g = _on(rng.randn(B, H, T, D), dtype, cuda)
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    tk.reset_launch_counts()
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, True, block_q,
                                 block_k)
    got = tk.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale, True,
                            block_q, block_k)
    torch.cuda.synchronize()
    tile = (block_q, block_k)
    assert tk.tile_counts() == {("flash_fwd", tile): 1,
                                ("flash_bwd_dkv", tile): 1,
                                ("flash_bwd_dq", tile): 1}
    assert tk.dtype_counts() == {(n, (dtype,)): 1 for n in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    assert out.dtype == getattr(torch, dtype)
    assert all(a.dtype == getattr(torch, dtype) for a in got)
    ex = fl.flash_excess(q, k, v, g, out, lse, got, qs, ks, scale, True,
                         block_k, dtype)
    assert max(ex["out"], ex["dq"], ex["dk"], ex["dv"]) <= 1.0, ex
    assert ex["lse"] <= 1e-4, ex
    assert float(out[0, :, 5].float().abs().max()) == 0.0
    assert float(got[0][0, :, 5].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LOW)
@pytest.mark.parametrize("D,offset", [(48, 0), (99, 0), (100, 0), (64, 1),
                                      (64, 8)])
def test_flash_staging_paths_on_card(cuda, dtype, D, offset):
    """The chunked staging (16 bytes of the staged type: 8 fp16 values, or 8
    fp8 values widened) and the one-element path: D = 99 and 100 are not
    whole chunks of 8, ``offset`` 1 moves every operand off its chunk
    alignment, 8 moves fp8 operands by one 8-byte chunk (still chunked)
    and fp16 operands off 16 bytes."""
    rng = onp.random.RandomState(16)
    B, H, T = 2, 3, 100
    arrays = [*_qkv(rng, B, H, T, T, D), rng.randn(B, H, T, D)]

    def shifted(a):
        t = _tt(a, dtype)
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=cuda)
        s = buf[offset:].view(t.shape)
        s.copy_(t)
        return s

    q, k, v, g = (shifted(a) for a in arrays)
    qs, ks = _ragged_ids(B, T, cuda)
    scale = 1 / D ** 0.5
    out, lse = tk.flash_fwd_cuda(q, k, v, qs, ks, scale, True)
    got = tk.flash_bwd_cuda(q, k, v, out, lse, g, qs, ks, scale, True)
    torch.cuda.synchronize()
    ex = fl.flash_excess(q, k, v, g, out, lse, got, qs, ks, scale, True,
                         tk.flash_block_k(), dtype)
    assert max(ex["out"], ex["dq"], ex["dk"], ex["dv"]) <= 1.0, ex
    assert ex["lse"] <= 1e-4, ex


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", LOW)
def test_flash_overflow_shows_on_card(cuda, dtype):
    """A gradient past the format's range is written as XLA writes it: inf
    (float16, float8_e5m2) or NaN (float8_e4m3fn), never a saturated finite
    value, by the kernels and the plain version alike."""
    rng = onp.random.RandomState(17)
    B, H, T, D = 1, 2, 64, 64
    q, k, v = (_on(a, dtype, cuda) for a in _qkv(rng, B, H, T, T, D))
    big = {"float16": 6e4, "float8_e4m3fn": 440.0, "float8_e5m2": 5.5e4}
    g = _on(onp.full((B, H, T, D), big[dtype]), dtype, cuda)
    out, lse = tk.flash_fwd_cuda(q, k, v, None, None, 1 / 8, True)
    dq, dk, dv = tk.flash_bwd_cuda(q, k, v, out, lse, g, None, None, 1 / 8,
                                   True)
    _, _, pv = tk.attention_bwd_plain(q, k, v, out, lse, g, None, None,
                                      1 / 8, True)
    torch.cuda.synchronize()
    # key 0 sums p g over all 64 queries: far past the range
    for t in (dv, pv):
        first = t[0, :, 0].float()
        if dtype == "float8_e4m3fn":
            assert bool(first.isnan().all())
        else:
            assert bool(first.isinf().all())
    assert bool(dv.float().isfinite().any())


@pytest.mark.cuda
@pytest.mark.parametrize("gdtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("block_rows", tk.ROW_BLOCKS)
def test_float16_row_kernels_match_plain_at_every_tile_on_card(
        cuda, block_rows, gdtype):
    rng = onp.random.RandomState(13)
    tk.reset_launch_counts()
    for rows, d in ((37, 768), (1, 100)):
        x = _t(rng.randn(rows, d).astype("float32") * 2).to(cuda,
                                                              torch.float16)
        g = _t(rng.randn(d).astype("float32")).to(cuda, gdtype)
        b = _t(rng.randn(d).astype("float32")).to(cuda, gdtype)
        out = tk.layer_norm_cuda(x, g, b, 1e-5, block_rows)
        sm = tk.softmax_cuda(x, block_rows)
        torch.cuda.synchronize()
        assert out.dtype == sm.dtype == torch.float16
        _assert_low(out, tk.layer_norm_plain(x, g, b, 1e-5), "float16",
                    steps=4 if gdtype == torch.float32 else 8)
        _assert_low(sm, tk.softmax_plain(x), "float16")
    gname = str(gdtype).replace("torch.", "")
    assert tk.dtype_counts() == {("layer_norm", ("float16", gname)): 2,
                                 ("softmax", ("float16",)): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset", [(64, 50257, 0), (64, 50257, 1),
                                           (3, 4096, 0), (7, 4103, 3),
                                           (4096, 768, 0)])
def test_float16_softmax_wide_and_narrow_on_card(cuda, rows, d, offset):
    rng = onp.random.RandomState(21)
    buf = torch.empty(rows * d + offset, dtype=torch.float16, device=cuda)
    x = buf[offset:].view(rows, d)
    x.copy_(_t(rng.randn(rows, d).astype("float32") * 4))
    y = tk.softmax_cuda(x)
    torch.cuda.synchronize()
    ref = tk.softmax_plain(x)
    diff = (y.float() - ref.float()).abs()
    # one fp16 step of the value (the kernel and the plain version round
    # one fp32 value); subnormal outputs within the smallest step
    assert bool((diff <= 2 * U["float16"] * ref.float().abs() + 2 ** -24)
                .all()), float(diff.max())
