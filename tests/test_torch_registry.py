"""PyTorch/CUDA port: the op registry and its ``invoke``, against the JAX
package's ``mxnet_tpu.ops.registry`` on the CPU.

Registry errors, ``invoke(out=...)``, ``apply_op``, the per-attribute
function cache, ``differentiable`` and ``needs_rng``, the error
normalisation, and the AMP cast at ``invoke``: while AMP is on, an op in
``amp.MXU_OPS`` casts its float32 tensor operands to the AMP dtype at
entry, which must give bit for bit what casting each op's float32
arguments by hand gives (the cast at the op that the registry replaced),
and the reference's dtypes. Values compared
with the reference use rtol 1e-5, atol 1e-6 (fp32); bf16 results against
the reference's bf16 use one bf16 ulp of the largest entry (2**-8, GEMMs
summed in another order). Tests marked ``cuda`` run on the card.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, amp
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import dtype_name
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _names(reg):
    """A registry's names less the tests' scratch ops (``_test_*``)."""
    return {n for n in reg.list_ops() if not n.startswith("_test_")}


def test_register_twice_and_unknown_names_raise_as_the_reference():
    from mxnet_tpu.base import MXNetError as JErr
    from mxnet_tpu.ops import registry as jreg

    for reg, err in ((jreg, JErr), (treg, MXNetError)):
        with pytest.raises(err, match="already registered"):
            reg.register("add", lambda **a: None)
        with pytest.raises(err, match="already registered"):
            reg.register_alias("add", "subtract")
        with pytest.raises(err, match="not registered"):
            reg.get_op("no_such_op_anywhere")
    # the tests' scratch ops (``_test_*``, registered in either registry by
    # other test modules of the same process) are not reference names
    port_ops = _names(treg)
    ref_ops = _names(jreg)
    slice_ops = {"fully_connected", "layer_norm", "embedding", "leaky_relu",
                 "activation", "softmax", "log_softmax", "masked_softmax",
                 "dropout", "pick", "one_hot", "multihead_attention",
                 "flash_attention", "take", "take_along_axis", "topk",
                 "where", "slice_key", "index_update", "index_add", "sum",
                 "matmul", "add", "linalg_svd", "fft", "quantile"}
    assert slice_ops <= port_ops and slice_ops <= ref_ops
    assert port_ops <= ref_ops, sorted(port_ops - ref_ops)


def test_register_alias_shares_the_op():
    name = "_test_registry_alias_of_add"
    if name not in treg._OPS:
        treg.register_alias(name, "add")
    assert treg.get_op(name) is treg.get_op("add")
    out = treg.apply_op(name, tnp.array([1, 2]), 3)
    assert out.tolist() == [4, 5] and dtype_name(out.dtype) == "int32"


def test_invoke_out_and_apply_op_match_reference():
    import mxnet_tpu as mx
    from mxnet_tpu.ops import registry as jreg

    x = onp.arange(6, dtype="float32").reshape(2, 3)
    for mod, reg in ((mx, jreg), (tmx, treg)):
        a = mod.np.array(x)
        dst = mod.np.zeros((2, 3))
        ret = reg.invoke(reg.get_op("multiply"), [a, 2.0], {}, out=dst)
        assert ret is dst
        onp.testing.assert_array_equal(dst.asnumpy(), x * 2)
        outs = (mod.np.zeros((1,)), mod.np.zeros((1,)))
        got = reg.apply_op("split", a.reshape((-1,)),
                           indices_or_sections=2, out=outs)
        assert got is outs
        onp.testing.assert_array_equal(outs[1].asnumpy(), x.ravel()[3:])
        s = reg.apply_op("sum", a, axis=1, keepdims=True)
        assert s.shape == (2, 1)


def test_op_fn_is_cached_per_attribute_set():
    op = treg.get_op("sum")
    assert op.fn(axis=1) is op.fn(axis=1)
    assert op.fn(axis=(0, 1)) is op.fn(axis=[0, 1])   # frozen attrs
    assert op.fn(axis=1) is not op.fn(axis=0)
    door = tnn._LN
    f = door.fn(axis=-1, eps=1e-5)
    assert door.fn(axis=-1, eps=1e-5) is f
    assert door.op is treg.get_op("layer_norm")


def test_outputs_take_the_reference_dtypes():
    i = tnp.array([[1, 2], [3, 4]])
    assert dtype_name(i.sum().dtype) == "int32"          # torch: int64
    assert dtype_name(i.argmax().dtype) == "int32"
    assert dtype_name(tnp.cumsum(i).dtype) == "int32"
    assert dtype_name(tnp.float_power(i, 2).dtype) == "float32"


def test_differentiable_and_errors():
    x = tnp.array([3.0, 1.0, 2.0])
    x.attach_grad()
    with tmx.autograd.record():
        idx = tnp.argsort(x)
        y = (x * 2).sum()
    assert not idx._data.requires_grad             # differentiable=False
    assert y._data.requires_grad
    with pytest.raises(MXNetError, match="op 'matmul' failed"):
        tnp.matmul(tnp.ones((2, 3)), tnp.ones((2, 3)))
    with pytest.raises(ValueError):
        tnp.squeeze(tnp.ones((2, 3)), 0)


def test_needs_rng_draws_from_the_device_generator():
    """``dropout`` through ``invoke`` takes the generator of its operand's
    device as a leading operand: the same seed gives the same mask as the
    tensor-level door."""
    x = onp.ones((64, 64), "float32")
    assert treg.get_op("dropout").needs_rng
    try:
        trandom.seed(11)
        a = tnpx.dropout(tnp.array(x), p=0.5, mode="always").asnumpy()
        trandom.seed(11)
        b = tnn.dropout(torch.from_numpy(x), 0.5, training=True).numpy()
        onp.testing.assert_array_equal(a, b)
        trandom.seed(12)
        c = tnpx.dropout(tnp.array(x), p=0.5, mode="always").asnumpy()
        assert not onp.array_equal(a, c)
    finally:
        trandom.seed(0)      # the port's default seed, for the tests after


# -- AMP: cast once, in the registry -------------------------------------------
def _cast_by_hand(*args):
    """An MXU op's arguments as the cast at the op gave them: float32
    tensors in bf16, everything else as it is."""
    return [a.to(torch.bfloat16) if isinstance(a, torch.Tensor) and
            a.dtype == torch.float32 else a for a in args]


def test_amp_cast_at_invoke_matches_the_cast_by_hand_bit_for_bit():
    rs = onp.random.RandomState(7)
    x = torch.from_numpy(rs.randn(4, 6).astype("float32"))
    w = torch.from_numpy(rs.randn(5, 6).astype("float32"))
    b = torch.from_numpy(rs.randn(5).astype("float32"))
    q, k, v = (torch.from_numpy(rs.randn(2, 8, 8).astype("float32"))
               for _ in range(3))
    xb, wb, bb = _cast_by_hand(x, w, b)
    fc_want = torch.matmul(xb, wb.t()) + bb
    mm_want = torch.matmul(xb, wb.t())
    with amp.autocast("bfloat16"):
        fc_door = tnn.fully_connected(x, w, b)
        fc_nd = tnpx.fully_connected(tnp.array(x.numpy()),
                                     tnp.array(w.numpy()),
                                     tnp.array(b.numpy()), num_hidden=5)
        mm_door = tnn.matmul(x, w.t())
        mm_nd = tnp.matmul(tnp.array(x.numpy()), tnp.array(w.t().numpy()))
        att_door = tnn.multihead_attention(q, k, v, num_heads=2,
                                           causal=True)
        ln = tnn.layer_norm(x, torch.ones(6), torch.zeros(6))
    for got, want in ((fc_door, fc_want), (fc_nd._data, fc_want),
                      (mm_door, mm_want), (mm_nd._data, mm_want)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)
    att_want = tnn.multihead_attention(*_cast_by_hand(q, k, v), num_heads=2,
                                       causal=True)
    assert att_door.dtype == torch.bfloat16 and torch.equal(att_door,
                                                            att_want)
    assert ln.dtype == torch.float32            # not an MXU op: no cast
    assert tnn.fully_connected(x, w, b).dtype == torch.float32   # AMP off


def test_amp_dtypes_at_invoke_match_reference():
    import mxnet_tpu as mx
    from mxnet_tpu import amp as jamp

    rs = onp.random.RandomState(8)
    x = rs.randn(4, 6).astype("float32")
    w = rs.randn(5, 6).astype("float32")
    outs = []
    for mod, a in ((mx, jamp), (tmx, amp)):
        with a.autocast("bfloat16"):
            fc = mod.npx.fully_connected(mod.np.array(x), mod.np.array(w),
                                         no_bias=True, num_hidden=5)
            sm = mod.npx.log_softmax(fc)
            ln = mod.npx.layer_norm(mod.np.array(x), mod.np.ones((6,)),
                                    mod.np.zeros((6,)))
        outs.append((fc, sm, ln))
    for want, got in zip(*outs):
        assert dtype_name(got.dtype) == dtype_name(want.dtype)
        w_, g_ = (v.asnumpy().astype("float32") for v in (want, got))
        assert float(onp.abs(g_ - w_).max()) <= \
            2.0 ** -8 * float(onp.abs(w_).max())


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_registry_doors_launch_the_kernels_on_the_card(cuda):
    """The tensor-level doors and ``invoke`` on NDArrays launch the flash
    forward, dK/dV, dQ and LayerNorm kernels, and the counters show it."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    rs = onp.random.RandomState(9)
    q = torch.from_numpy(rs.randn(2, 64, 128).astype("float32")).to(cuda)
    x = torch.from_numpy(rs.randn(64, 128).astype("float32")).to(cuda)
    g, b = torch.ones(128, device=cuda), torch.zeros(128, device=cuda)
    ck.reset_launch_counts()
    qq = q.clone().requires_grad_()
    tnn.multihead_attention(qq, qq, qq, num_heads=2, causal=True).sum() \
        .backward()
    tnn.layer_norm(x, g, b)
    door = ck.launch_counts()
    assert door["flash_fwd"] == 1 and door["flash_bwd_dkv"] == 1 and \
        door["flash_bwd_dq"] == 1 and door["layer_norm"] == 1, door
    ck.reset_launch_counts()
    with tmx.gpu():
        qn = tnp.array(q)
        qn.attach_grad()
        with tmx.autograd.record():
            out = tnpx.multihead_attention(qn, qn, qn, num_heads=2,
                                           causal=True)
        out.backward()
        tnpx.layer_norm(tnp.array(x), tnp.array(g), tnp.array(b))
    nd = ck.launch_counts()
    assert nd == door, (nd, door)
    onp.testing.assert_allclose(qn.grad.asnumpy(), qq.grad.cpu().numpy(),
                                rtol=1e-5, atol=1e-6)


# The reference's op names the port does not register yet, by the reference
# module that defines each (ROADMAP A8, A10 (2)): a PR that ports names
# takes them out here, so the queue is checked, not counted by hand.
QUEUED = {
    "tp_collectives": [
        "tp_copy", "tp_gather", "tp_sum"
    ],
    "Custom": ["Custom"],
}


def test_missing_names_are_exactly_those_queued():
    """The port's registry is the reference's less ``QUEUED``: 870 of the
    reference's 874 names, every name of ``legacy_elemwise``,
    ``linalg_legacy``, ``npi_manip``, ``extra``, ``optimizer_ops``,
    ``quantized_ops``, ``contrib.quantization`` and ``graph_image_ops``
    among them but ``Custom``; each queued name under the reference module that
    defines it. Both sides leave out the tests' scratch ops (``_test_*``),
    which other test modules of the same process may have registered."""
    from mxnet_tpu.ops import registry as jreg

    ref = _names(jreg)
    port = _names(treg)
    queued = {n for names in QUEUED.values() for n in names}
    assert sum(len(v) for v in QUEUED.values()) == len(queued) == 4
    assert port == ref - queued, (sorted(ref - queued - port),
                                  sorted(port - (ref - queued)))
    assert len(ref) == 874 and len(port) == 870
    for key, names in QUEUED.items():
        module = "mxnet_tpu.ops.npi_manip" if key == "Custom" else (
            "mxnet_tpu." + key if "." in key else "mxnet_tpu.ops." + key)
        for n in names:
            assert jreg.get_op(n)._make_fn.__module__ == module, (n, key)
