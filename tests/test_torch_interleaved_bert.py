"""PyTorch/CUDA port: ``tests/torch_script_interleaved_bert.py`` (a
GluonNLP-style BERT with interleaved attention, ``arange_like`` positions,
``softmax_cross_entropy`` losses, ``amp_cast``, ``multi_all_finite`` with a
dynamic loss scale and op-level LAMB) through both packages on one
``.params`` file, on the CPU, at 2 layers, 64 units, 4 heads, FFN 128,
vocabulary 97, batch 2 x 16 tokens.

Held against the JAX package in fp32: the interleaved encoder's output and
the loss within 1e-5, every gradient and moment within 1e-5 of the net's
largest entry (a key bias's gradient is rounding noise), and after one
``multi_mp_lamb_update`` every weight and master within 1e-5 of its largest
entry. In the port: the encoder against the zoo ``BERTModel``'s (the
``multihead_attention`` route) on the permuted weights within 1e-5; the
``lamb_update_phase1``/``phase2`` form against the multi-tensor step within
1e-6; the bf16 step's dtypes, its loss within 2^-6 of the fp32 step's and
each bf16 weight its master rounded; an overflowing step skipped with every
weight bitwise as it was and the scale halved; the fp32 gradients against a
float64 twin. The ``cuda`` test holds the bf16 and fp32 steps' losses and
gradients on the card to the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_script_interleaved_bert as sb
from torch_legacy_cases import _close

CFG = sb.config(num_layers=2, units=64, num_heads=4, hidden_size=128,
                vocab_size=97, max_length=32)
B, T = 2, 16
LR = 1e-2
RTOL = 1e-5
BF16_RTOL = 2.0 ** -6


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("interleaved_bert") / "bert.params")
    sb.save_params(path, sb.init_weights(CFG, seed=3))
    return path


@pytest.fixture(scope="module")
def batch():
    return sb.make_batch(CFG, B, T, seed=4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _mods():
    import mxnet_tpu as mx

    return (("jax", mx), ("port", tmx))


_RUNS = {}


def _run(mx, params, batch, dtype, step):
    """The encoder's output, the loss, the gradients, and after one step
    ``step`` the weights and states, in ``mx`` on the CPU (numpy); made
    once a module."""
    key = (mx.__name__, dtype, step)
    if key in _RUNS:
        return _RUNS[key]
    ctx = mx.cpu()
    P = sb.load_params(mx, params, CFG, ctx, dtype=dtype)
    state = sb.lamb_state(mx, P, ctx)
    data = sb.to_nd(mx, batch, CFG, ctx)
    seq = []
    loss = sb.backward(mx, P, data, CFG, 1.0, dtype, seq=seq)
    seq = seq[0].asnumpy()
    grads = {n: w.grad.asnumpy() for n, w in P.items()}
    if step == "mp":
        sb.update_mp_lamb(mx, P, state, LR, 1, 1.0)
    else:
        sb.update_phases(mx, P, state, LR, 1)
    after = {n: (str(w.dtype), str(w.grad.dtype), w.asnumpy())
             for n, w in P.items()}
    states = {n: {k: v.asnumpy() for k, v in s.items() if k != "upd"}
              for n, s in state.items()}
    _RUNS[key] = (seq, float(loss.asnumpy()[0]), grads, after, states)
    return _RUNS[key]


def _close_all(got, want, rtol):
    """Each ``got[n]`` against ``want[n]`` within ``rtol`` of the largest
    entry of all of ``want``: a gradient (or a moment) of the key bias is
    rounding noise (softmax ignores a shift of a row's scores), so each
    tensor is held at the net's scale, not at its own."""
    scale = max(float(abs(w).max()) for w in want.values())
    for n, w in want.items():
        err = float(abs(got[n].astype("float64") - w).max())
        assert err <= rtol * scale, (n, err, scale)


def test_encoder_matches_the_zoo_and_the_reference(params, batch):
    """The interleaved encoder (time-major) on the permuted weights is the
    zoo ``BERTModel``'s sequence output on the file's weights; the port's
    is the reference's."""
    got = _run(tmx, params, batch, "float32", "mp")[0]
    _close(got.transpose(1, 0, 2),
           sb.zoo_sequence(tmx, params, CFG, batch, tmx.cpu()), RTOL)
    import mxnet_tpu as mx

    _close(got, _run(mx, params, batch, "float32", "mp")[0], RTOL)


def test_permute_qkv_is_the_per_head_order():
    """Row ``(h, j, d)`` of the permuted ``attn_qkv`` is row ``(j, h, d)``
    of the zoo's [q | k | v]."""
    heads, d, c = 3, 2, 5
    w = onp.arange(3 * heads * d * c).reshape(3 * heads * d, c)
    p = sb.permute_qkv(w, heads).reshape(heads, 3, d, c)
    z = w.reshape(3, heads, d, c)
    for h in range(heads):
        for j in range(3):
            onp.testing.assert_array_equal(p[h, j], z[j, h])


def test_fp32_loss_gradients_and_update_match_reference(params, batch):
    """fp32: the loss, every gradient, and one ``multi_mp_lamb_update``
    step: the weights (each within 1e-5 of its largest entry), the masters
    and the moments (gradients and moments at the net's scale)."""
    (_, jl, jg, jw, js), (_, pl, pg, pw, ps) = (
        _run(mx, params, batch, "float32", "mp") for _, mx in _mods())
    assert abs(pl - jl) <= RTOL * abs(jl)
    _close_all(pg, jg, RTOL)
    for n in jg:
        assert pw[n][:2] == jw[n][:2] == ("float32",) * 2, n
        _close(pw[n][2], jw[n][2], RTOL)
    for k in js[next(iter(js))]:
        _close_all({n: ps[n][k] for n in ps}, {n: js[n][k] for n in js},
                   RTOL)


def test_phases_step_is_the_multi_tensor_step(params, batch):
    """The fp32 form, ``lamb_update_phase1`` -> the norms ->
    ``lamb_update_phase2`` a tensor, moves the weights and moments as one
    ``multi_mp_lamb_update`` does (within 1e-6 of each largest entry: the
    norms of the two forms sum in other orders)."""
    _, _, _, mw, ms = _run(tmx, params, batch, "float32", "mp")
    _, _, _, fw, fs = _run(tmx, params, batch, "float32", "phases")
    for n in mw:
        _close(fw[n][2], mw[n][2], 1e-6)
        _close(fw[n][2], ms[n]["w32"], 1e-6)
    for k in ("mean", "var"):
        _close_all({n: fs[n][k] for n in fs}, {n: ms[n][k] for n in ms},
                   1e-6)


def test_bf16_step(params, batch):
    """The bf16 step in the port: bf16 Dense weights and gradients, fp32
    tables, LayerNorms, masters and moments; the loss within 2^-6 of the
    fp32 step's; every bf16 weight after the update is its fp32 master
    rounded (the op's bf16 operands are held against the reference in
    ``test_torch_optimizer_ops.py``; a first LAMB step is the gradient's
    sign, so the two precisions' steps differ where a gradient is near
    0)."""
    import torch

    _, l16, _, w16, s16 = _run(tmx, params, batch, "bfloat16", "mp")
    _, l32, _, _, _ = _run(tmx, params, batch, "float32", "mp")
    assert abs(l16 - l32) <= BF16_RTOL * abs(l32)
    for n, (wdt, gdt, w) in w16.items():
        want = "float32" if sb.is_fp32(n) else "bfloat16"
        assert (wdt, gdt) == (want, want), (n, wdt, gdt)
        assert all(str(v.dtype) == "float32" for v in s16[n].values()), n
        w32 = torch.from_numpy(s16[n]["w32"])
        onp.testing.assert_array_equal(
            w, w32.to(getattr(torch, want)).float().numpy())


def test_overflow_skips_the_step_and_halves_the_scale(params, batch):
    """A loss scale of 2^127 overflows: ``multi_all_finite`` is false, no
    weight, master or moment moves, and the scale halves; then a finite
    step applies."""
    ctx = tmx.cpu()
    P = sb.load_params(tmx, params, CFG, ctx)
    state = sb.lamb_state(tmx, P, ctx)
    data = sb.to_nd(tmx, batch, CFG, ctx)
    before = {n: w.asnumpy().copy() for n, w in P.items()}
    scaler = sb.LossScaler(scale=2.0 ** 127)
    _, applied = sb.train_step(tmx, P, state, data, CFG, scaler, LR, 1,
                               dtype="float32")
    assert not applied and scaler.scale == 2.0 ** 126
    for n, w in P.items():
        onp.testing.assert_array_equal(w.asnumpy(), before[n])
        assert not state[n]["mean"].asnumpy().any()
    scaler.scale = 1.0
    _, applied = sb.train_step(tmx, P, state, data, CFG, scaler, LR, 1,
                               dtype="float32")
    assert applied and any(not onp.array_equal(w.asnumpy(), before[n])
                           for n, w in P.items())


def test_gradients_against_float64(params, batch):
    """The port's fp32 gradients lie within 1e-5 of the float64 twin's
    (the net's largest gradient entry)."""
    grads = _run(tmx, params, batch, "float32", "mp")[2]
    _close_all(grads, sb.f64_grads(tmx, params, CFG, batch), RTOL)


@pytest.mark.cuda
def test_step_on_the_card(params, batch):
    """The bf16 and the fp32 step's loss and gradients on the card against
    the CPU: within 2^-6 (bf16) or 1e-4 (fp32, TF32 off) of the loss and of
    the net's largest gradient entry. (A first LAMB step is about each
    gradient's sign, so the updates are held where their inputs are the
    same, in ``test_torch_optimizer_ops.py``'s card test.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, rtol in (("bfloat16", BF16_RTOL), ("float32", 1e-4)):
            got = _loss_grads(tmx.gpu(), params, batch, dtype)
            want = _loss_grads(tmx.cpu(), params, batch, dtype)
            assert abs(got[0] - want[0]) <= rtol * abs(want[0]), dtype
            _close_all(got[1], want[1], rtol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _loss_grads(ctx, params, batch, dtype):
    with ctx:
        P = sb.load_params(tmx, params, CFG, ctx, dtype=dtype)
        for w in P.values():
            w.attach_grad()
        data = sb.to_nd(tmx, batch, CFG, ctx)
        loss = sb.backward(tmx, P, data, CFG, 1.0, dtype)
        return float(loss.asnumpy()[0]), {
            n: w.grad.asnumpy().astype("float32") for n, w in P.items()}
