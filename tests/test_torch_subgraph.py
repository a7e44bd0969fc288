"""PyTorch/CUDA port: ``mx.subgraph`` and the ``"tpu"`` backend's attention
fusion (``optimize_for``), against the JAX package, on the CPU.

Every case of ``tests/test_subgraph_passes.py`` runs in both packages on
the same numpy inputs (drawn from a seed): hand-written attention in the
three scale styles (divide, multiply, none), through the Symbol API, with
the softmax weights reused (no fusion), a plain matmul (no fusion), the
gradients through the fused graph, rank-3 operands, the (B, 1, 1, Tk)
key-padding mask (fused, with two segment-id inputs), a full (B, 1, Tq, Tk)
mask (no fusion) and cross-attention with Tq != Tk (no fusion). The port's
graph holds ``flash_attention`` exactly where the reference's does, and its
fused outputs and gradients agree with the JAX package's within rtol 2e-3,
atol 2e-4 (the reference's own bounds for fused against unfused). Also the
backend registry (``register_backend``/``register_pass``/``get_passes``,
an unknown backend refused), ``ones_like``/``_npi_where``, and on the card
the fused attention's forward and gradients against the unfused block,
with one launch of each flash kernel.

The blocks are the reference's ``_ManualAttention``/``_MaskedAttention``,
written through ``mx.np``/``mx.npx``; the port's body wraps the tensors a
block receives into NDArrays first (``gluon.block.wrap``).

The JAX package is imported inside the tests that use it, so ``pytest
--noconftest tests/test_torch_subgraph.py -m cuda`` collects this file on
a machine without JAX.
"""
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd as tag
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon.block import wrap
from mxnet_tpu_torch.symbol import topo_sort

TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _nodes(sym):
    """``sym``'s nodes in topological order, by its own package's sort."""
    return sys.modules[type(sym).__module__].topo_sort(sym._entries)


def _flash_count(sym):
    return sum(1 for n in _nodes(sym)
               if n.op is not None and n.op.name == "flash_attention")


def _ops(sym):
    return [n.op.name for n in _nodes(sym) if n.op]


def _graph(net):
    (cop, _, _), = net._cached.values()
    return cop.sym


class _ManualAttention(HybridBlock):
    """The reference's long-hand attention (test_subgraph_passes.py:18)."""

    def __init__(self, style="div"):
        super().__init__()
        self.style = style

    def forward(self, q, k, v):
        q, k, v = wrap((q, k, v))
        kt = tnp.swapaxes(k, -1, -2)
        logits = tnp.matmul(q, kt)
        d = q.shape[-1]
        if self.style == "div":
            logits = logits / (d ** 0.5)
        elif self.style == "mul":
            logits = logits * (1.0 / d ** 0.5)
        w = tnpx.softmax(logits, axis=-1)
        return tnp.matmul(w, v)


class _MaskedAttention(HybridBlock):
    """The reference's key-padding-masked attention (:150)."""

    def forward(self, q, k, v, mask):
        q, k, v, mask = wrap((q, k, v, mask))
        kt = tnp.swapaxes(k, -1, -2)
        logits = tnp.matmul(q, kt) / (q.shape[-1] ** 0.5)
        logits = tnp.where(mask, logits, tnp.array(-1e30, dtype="float32"))
        w = tnpx.softmax(logits, axis=-1)
        return tnp.matmul(w, v)


def _jax_blocks():
    import mxnet_tpu as mx
    from mxnet_tpu import np, npx

    class Manual(mx.gluon.HybridBlock):
        def __init__(self, style="div"):
            super().__init__()
            self.style = style

        def forward(self, q, k, v):
            logits = np.matmul(q, np.swapaxes(k, -1, -2))
            d = q.shape[-1]
            if self.style == "div":
                logits = logits / (d ** 0.5)
            elif self.style == "mul":
                logits = logits * (1.0 / d ** 0.5)
            return np.matmul(npx.softmax(logits, axis=-1), v)

    class Masked(mx.gluon.HybridBlock):
        def forward(self, q, k, v, mask):
            logits = np.matmul(q, np.swapaxes(k, -1, -2)) / \
                (q.shape[-1] ** 0.5)
            logits = np.where(mask, logits, np.array(-1e30, dtype="float32"))
            return np.matmul(npx.softmax(logits, axis=-1), v)

    return mx, Manual, Masked


def _run(net, arrays, np_, fused, grads=False, ag=None):
    """``net`` on ``arrays`` (optimized first when ``fused``): the output,
    and with ``grads`` the gradients of sum(out**2) for q, k, v."""
    if fused:
        net.optimize_for(*[np_.array(a) for a in arrays], backend="tpu")
    xs = [np_.array(a) for a in arrays]
    if not grads:
        return net(*xs).asnumpy(), None
    for a in xs[:3]:
        a.attach_grad()
    with ag.record():
        out = net(*xs)
        loss = (out * out).sum()
    loss.backward()
    return out.asnumpy(), [a.grad.asnumpy() for a in xs[:3]]


def _qkv(seed, *shapes):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*s).astype("float32") for s in shapes]


@pytest.mark.parametrize("style", ["div", "mul", "none"])
def test_attention_pattern_rewritten(style):
    """One ``flash_attention`` node in both packages, the fused output
    equal to the unfused one and to the JAX package's fused output."""
    mx, Manual, _ = _jax_blocks()
    arrays = _qkv(0, *[(2, 2, 8, 4)] * 3)
    want, _ = _run(_ManualAttention(style), arrays, tnp, fused=False)
    net = _ManualAttention(style)
    got, _ = _run(net, arrays, tnp, fused=True)
    jnet = Manual(style)
    jgot, _ = _run(jnet, arrays, mx.np, fused=True)
    onp.testing.assert_allclose(got, want, **TOL)
    onp.testing.assert_allclose(got, jgot, **TOL)
    assert _ops(_graph(net)) == ["flash_attention"]
    (jcop, _, _), = jnet._cached.values()
    assert _flash_count(_graph(net)) == _flash_count(jcop.sym) == 1


def test_attention_fusion_via_symbol_api():
    import mxnet_tpu.symbol as jsym

    import mxnet_tpu_torch.symbol as tsym

    counts = []
    for S in (tsym, jsym):
        q, k, v = S.var("q"), S.var("k"), S.var("v")
        logits = S.matmul(q, S.swapaxes(k, axis1=-1, axis2=-2)) * 0.125
        out = S.matmul(S.softmax(logits, axis=-1), v)
        fused = out.optimize_for("tpu")
        counts.append(_flash_count(fused))
        head = fused._entries[0][0]
        assert head.attrs == {"scale": 0.125, "causal": False}
    assert counts == [1, 1]


def test_fused_symbol_runs_through_the_executor():
    import mxnet_tpu_torch.symbol as tsym

    q, k, v = tsym.var("q"), tsym.var("k"), tsym.var("v")
    out = tsym.matmul(tsym.softmax(
        tsym.matmul(q, tsym.swapaxes(k, axis1=-1, axis2=-2)) * 0.5,
        axis=-1), v)
    arrays = dict(zip("qkv", _qkv(3, *[(1, 2, 8, 4)] * 3)))
    args = {n: tnp.array(a) for n, a in arrays.items()}
    want = out.bind(args=args).forward()[0].asnumpy()
    got = out.optimize_for("tpu").bind(args=args).forward()[0].asnumpy()
    onp.testing.assert_allclose(got, want, **TOL)


def test_no_false_positive_when_weights_reused():
    import mxnet_tpu.symbol as jsym

    import mxnet_tpu_torch.symbol as tsym

    for S in (tsym, jsym):
        q, k, v = S.var("q"), S.var("k"), S.var("v")
        w = S.softmax(S.matmul(q, S.swapaxes(k, axis1=-1, axis2=-2)),
                      axis=-1)
        fused = S.Group([S.matmul(w, v), w]).optimize_for("tpu")
        assert _flash_count(fused) == 0


def test_plain_matmul_not_rewritten():
    import mxnet_tpu.symbol as jsym

    import mxnet_tpu_torch.symbol as tsym

    for S in (tsym, jsym):
        out = S.matmul(S.var("a"), S.var("b")).optimize_for("tpu")
        assert _flash_count(out) == 0


def test_fused_attention_gradients_match():
    """Gradients through the fused graph (one tape node) against the
    unfused eager ones and the JAX package's fused ones."""
    mx, Manual, _ = _jax_blocks()
    arrays = _qkv(1, *[(1, 2, 8, 4)] * 3)
    _, g0 = _run(_ManualAttention("div"), arrays, tnp, False, True, tag)
    net = _ManualAttention("div")
    out, g1 = _run(net, arrays, tnp, True, True, tag)
    _, gj = _run(Manual("div"), arrays, mx.np, True, True, mx.autograd)
    for a, b, c in zip(g1, g0, gj):
        onp.testing.assert_allclose(a, b, **TOL)
        onp.testing.assert_allclose(a, c, **TOL)
    recorded = [v for k, v in net._cached.items() if k[2]]
    assert _ops(recorded[0][0].sym) == ["flash_attention"]


def test_rank3_headless_attention_fuses_and_runs():
    mx, Manual, _ = _jax_blocks()
    arrays = _qkv(5, *[(2, 8, 4)] * 3)
    want, _ = _run(_ManualAttention("div"), arrays, tnp, False)
    net = _ManualAttention("div")
    got, _ = _run(net, arrays, tnp, True)
    jgot, _ = _run(Manual("div"), arrays, mx.np, True)
    onp.testing.assert_allclose(got, want, **TOL)
    onp.testing.assert_allclose(got, jgot, **TOL)
    assert _flash_count(_graph(net)) == 1


def test_masked_attention_pattern_rewritten():
    mx, _, Masked = _jax_blocks()
    arrays = _qkv(7, *[(2, 2, 8, 4)] * 3)
    valid = onp.ones((2, 1, 1, 8), onp.float32)
    valid[0, :, :, 5:] = 0
    arrays.append(valid)
    want, _ = _run(_MaskedAttention(), arrays, tnp, False)
    net = _MaskedAttention()
    got, _ = _run(net, arrays, tnp, True)
    jnet = Masked()
    jgot, _ = _run(jnet, arrays, mx.np, True)
    sym = _graph(net)
    (jcop, _, _), = jnet._cached.values()
    assert _flash_count(sym) == _flash_count(jcop.sym) == 1
    (head,) = [n for n in topo_sort(sym._entries)
               if n.op is not None and n.op.name == "flash_attention"]
    assert len(head.inputs) == 5
    assert sorted(_ops(sym)) == sorted(_ops(jcop.sym))
    onp.testing.assert_allclose(got[:, :, :5], want[:, :, :5], **TOL)
    onp.testing.assert_allclose(got[1], want[1], **TOL)
    onp.testing.assert_allclose(got, jgot, **TOL)


def test_masked_attention_not_rewritten_for_full_masks():
    mx, _, Masked = _jax_blocks()
    arrays = _qkv(8, *[(1, 1, 4, 4)] * 3)
    arrays.append(onp.tril(onp.ones((4, 4), onp.float32)).reshape(1, 1, 4, 4))
    want, _ = _run(_MaskedAttention(), arrays, tnp, False)
    net = _MaskedAttention()
    got, _ = _run(net, arrays, tnp, True)
    jnet = Masked()
    jgot, _ = _run(jnet, arrays, mx.np, True)
    (jcop, _, _), = jnet._cached.values()
    assert _flash_count(_graph(net)) == _flash_count(jcop.sym) == 0
    onp.testing.assert_allclose(got, want, **TOL)
    onp.testing.assert_allclose(got, jgot, **TOL)


def test_masked_cross_attention_not_rewritten():
    mx, _, Masked = _jax_blocks()
    arrays = _qkv(9, (1, 1, 4, 4), (1, 1, 8, 4), (1, 1, 8, 4))
    arrays.append(onp.ones((1, 1, 1, 8), onp.float32))
    want, _ = _run(_MaskedAttention(), arrays, tnp, False)
    net = _MaskedAttention()
    got, _ = _run(net, arrays, tnp, True)
    jnet = Masked()
    jgot, _ = _run(jnet, arrays, mx.np, True)
    (jcop, _, _), = jnet._cached.values()
    assert _flash_count(_graph(net)) == _flash_count(jcop.sym) == 0
    onp.testing.assert_allclose(got, want, **TOL)
    onp.testing.assert_allclose(got, jgot, **TOL)


def test_backend_registry():
    assert {"default", "tpu"} <= set(subgraph.list_backends())
    seen = []
    subgraph.register_backend("torch_test_backend")

    @subgraph.register_pass("torch_test_backend")
    def _count(sym):
        seen.append(len(topo_sort(sym._entries)))
        return sym

    assert subgraph.get_passes("TORCH_TEST_BACKEND") == [_count]
    net = _ManualAttention("none")
    arrays = _qkv(2, *[(1, 1, 4, 4)] * 3)
    net.optimize_for(*[tnp.array(a) for a in arrays],
                     backend="torch_test_backend")
    assert seen and _flash_count(_graph(net)) == 0
    with pytest.raises(MXNetError, match="not registered"):
        net.optimize_for(*[tnp.array(a) for a in arrays], backend="nope")
    with pytest.raises(MXNetError, match="unsupported options"):
        net.optimize_for(*[tnp.array(a) for a in arrays], backend="tpu",
                         dedup_subgraph=True)
    net.hybridize()
    assert net._pass_backend is None


def test_ones_like_and_npi_where():
    import mxnet_tpu as mx

    x = onp.array([[1.0, -2.0], [0.0, 3.0]], "float32")
    for op, args in (("ones_like", [x]), ("_npi_where", [x > 0, x, -x]),
                     ("_npi_ones_like", [x])):
        got = tmx.ops.apply_op(op, *[tnp.array(a) for a in args]).asnumpy()
        want = mx.ops.registry.apply_op(
            op, *[mx.np.array(a) for a in args]).asnumpy()
        onp.testing.assert_array_equal(got, want)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_fused_attention_on_the_card(cuda, masked):
    """The fused graph on the card against the unfused one (the
    ``"default"`` backend: the same trace without the pass) on the same
    inputs (FLASH_TOL 1e-4 of the largest entry forward, the flash
    tests' 1e-3 backward), the recorded program's captured forward holding
    one ``flash_fwd`` and its captured backward one ``flash_bwd_dkv`` and one
    ``flash_bwd_dq``."""
    B, H, T, D = 2, 4, 128, 64
    arrays = [torch.from_numpy(a).to(cuda)
              for a in _qkv(11, *[(B, H, T, D)] * 3)]
    if masked:
        valid = torch.ones(B, 1, 1, T, device=cuda)
        valid[0, ..., 96:] = 0
        arrays.append(valid)
    make = _MaskedAttention if masked else (lambda: _ManualAttention("div"))
    results = []
    for fused in (False, True):
        with tmx.gpu():     # the block's own constants on the card
            results.append(_fused_run(make(), arrays, fused))
    (o0, g0, _), (o1, g1, rec) = results
    assert rec["captured_launches"]["flash_fwd"] == 1
    bwd = rec["backward_captured_launches"]
    assert bwd["flash_bwd_dkv"] == 1 and bwd["flash_bwd_dq"] == 1
    assert abs(o1 - o0).max() <= 1e-4 * abs(o0).max()
    for a, b in zip(g1, g0):
        assert abs(a - b).max() <= 1e-3 * abs(b).max()


def _fused_run(net, arrays, fused):
    """Two recorded forwards and backwards of ``net`` (optimized with the
    ``"tpu"`` backend when ``fused``, else ``"default"``; the second replays
    both graphs): the last output, its q/k/v
    gradients and the recorded program's ``graph_stats``."""
    # unfused: the same trace without the pass, whose host constant is a
    # const node placed on the card before the capture
    net.optimize_for(*arrays, backend="tpu" if fused else "default")
    for _ in range(2):
        xs = [tmx.NDArray(a.clone()) for a in arrays]
        for a in xs[:3]:
            a.attach_grad()
        with tag.record():
            out = net(*xs)
            loss = (out * out).sum()
        tag.backward(loss)
    torch.cuda.synchronize()
    (cop, _, _), = [v for k, v in net._cached.items() if k[2]]
    rec, = [s for s in cop.graph_stats() if s.get("recorded")]
    assert rec["replays"] == 1 and rec["backward_replays"] == 1
    return out.asnumpy(), [a.grad.asnumpy() for a in xs[:3]], rec

