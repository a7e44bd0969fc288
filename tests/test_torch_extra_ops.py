"""PyTorch/CUDA port: the names of ``mxnet_tpu_torch/ops/extra.py`` that
this slice adds (``khatri_rao``, the four interleaved attention products,
``im2col``/``col2im``, the tensor helpers, ``masked_log_softmax``,
``softmax_cross_entropy``, ``amp_cast``/``amp_multicast`` and their
``_contrib_`` names) against the JAX package on the CPU.

Each name is a case of one parametrised test, on the inputs of
``tests/torch_extra_cases.py``: values within 1e-5 of the largest entry
(bitwise for integer, index, shape, bool, cast and creation outputs;
``torch_extra_cases.BF16_RTOL``, 2^-6 of the largest entry, for a case with
bf16 operands), dtypes equal, and the inputs' gradients (JAX ``grad``
against torch autograd) within the same bounds. An alias is checked to be
its target's ``Op`` in both registries and runs its target's first case.
The ``cuda`` test holds the card against the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_extra_cases as ec
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import aliases as taliases
from mxnet_tpu_torch.ops import registry as treg

# the names of the reference's extra.py that earlier slices ported
EARLIER = {
    "batch_dot", "depth_to_space", "space_to_depth", "bipartite_matching",
    "_contrib_bipartite_matching", "multibox_prior", "multibox_target",
    "multibox_detection", "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "blackman", "hamming", "hanning",
    "diagflat", "fill_diagonal", "rollaxis", "polyval", "tril_indices",
    "dot_csr", "_npi_blackman", "_npi_hamming", "_npi_hanning",
    "_npi_diagflat", "_npi_fill_diagonal", "_npi_rollaxis", "_npi_polyval",
    "_npi_tril_indices"}


@pytest.fixture
def cuda():
    """The card, with TF32 off, so fp32 products sum in fp32 as the CPU
    does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _reference_names(module):
    from mxnet_tpu.ops import registry as jreg

    return {n for n, op in jreg._OPS.items()
            if op._make_fn.__module__ == f"mxnet_tpu.ops.{module}"}


def test_names_are_the_references():
    """The table holds exactly the reference's ``extra`` names that earlier
    slices left (its own and their aliases), 29; the port now registers
    every name of the module, and the alias table all 217 of its entries
    (the last three since the quantized tier)."""
    names = _reference_names("extra")
    assert set(ec.EXTRA) == names - EARLIER, sorted(set(ec.EXTRA) ^
                                                    (names - EARLIER))
    assert len(ec.EXTRA) == 29 and EARLIER <= names
    assert names <= set(treg.list_ops())
    have = [a for a in taliases.ALIASES if a in treg._OPS]
    assert len(have) == 217 and len(taliases.ALIASES) == 217


def test_cases_follow_the_sweep():
    """Where ``tests/test_op_sweep.py`` has a spec, the first case here has
    its attributes and its inputs' shapes and dtypes."""
    import test_op_sweep as sweep

    shared = sorted(set(ec.EXTRA) & set(sweep.SPECS))
    assert len(shared) == 21
    for name in shared:
        build, attrs, _, _ = sweep.SPECS[name]
        mine = ec.cases(name)[0]
        assert mine[1] == attrs, (name, mine[1], attrs)
        want = [onp.asarray(a) for a in build()]
        got = ec.inputs(name, 0)
        assert [a.shape for a in got] == [a.shape for a in want], name
        assert [a.dtype.kind for a in got] == [a.dtype.kind for a in want], \
            name


@pytest.mark.parametrize("name", sorted(ec.EXTRA))
def test_name_matches_reference(name):
    if ec.target(name) != name:
        from mxnet_tpu.ops import registry as jreg

        assert treg.get_op(name) is treg.get_op(ec.target(name))
        assert jreg.get_op(name) is jreg.get_op(ec.target(name))
        ec.check_against_reference(name, first=True)
        return
    ec.check_against_reference(name)


def test_index_copy_keeps_the_last_row_of_a_repeated_index():
    """``index_copy`` with repeated indices writes the last row given for
    each (XLA's CPU scatter), through ``mx.nd`` as through the op, in the
    port and in the reference."""
    import mxnet_tpu as mx

    old = onp.zeros((4, 2), "float32")
    idx = onp.array([2, 0, 2, 2, 0], "int32")
    new = onp.arange(10, dtype="float32").reshape(5, 2)
    want = old.copy()
    for i, r in zip(idx, new):
        want[i] = r
    for mod in (mx, tmx):
        got = mod.nd.index_copy(mod.nd.array(old), mod.nd.array(idx),
                                mod.nd.array(new)).asnumpy()
        onp.testing.assert_array_equal(got, want)
        got = mod.nd._contrib_index_copy(mod.nd.array(old),
                                         mod.nd.array(idx),
                                         mod.nd.array(new)).asnumpy()
        onp.testing.assert_array_equal(got, want)


def test_interleaved_attention_is_attention():
    """``selfatt_qk`` -> ``softmax`` -> ``selfatt_valatt`` over a fused
    (T, B, 3 H D) projection interleaved per head as (H, 3, D) is the
    attention of its q, k, v (the port's ``multihead_attention`` on the
    de-interleaved heads), within 1e-5 of the largest entry; the encdec pair
    likewise with q apart from an (H, 2, D) key-value projection."""
    from mxnet_tpu_torch.ops import nn as tnn

    rng = onp.random.RandomState(3)
    t, b, h, d, tk = 7, 2, 3, 4, 5
    qkv = rng.randn(t, b, 3 * h * d).astype("float32")
    att = tnd.softmax(tnd.interleaved_matmul_selfatt_qk(tnd.array(qkv),
                                                        heads=h), axis=-1)
    out = tnd.interleaved_matmul_selfatt_valatt(tnd.array(qkv), att, heads=h)
    r = torch.from_numpy(qkv).reshape(t, b, h, 3, d)
    q, k, v = (r[..., j, :].permute(1, 0, 2, 3).reshape(b, t, h * d)
               for j in range(3))
    want = tnn.multihead_attention(q, k, v, num_heads=h).permute(1, 0, 2)
    ec.lc._close(out.asnumpy(), want.numpy(), 1e-5)
    qe = rng.randn(t, b, h * d).astype("float32")
    kv = rng.randn(tk, b, 2 * h * d).astype("float32")
    att = tnd.softmax(tnd.interleaved_matmul_encdec_qk(
        tnd.array(qe), tnd.array(kv), heads=h), axis=-1)
    out = tnd.interleaved_matmul_encdec_valatt(tnd.array(kv), att, heads=h)
    r = torch.from_numpy(kv).reshape(tk, b, h, 2, d)
    k, v = (r[..., j, :].permute(1, 0, 2, 3).reshape(b, tk, h * d)
            for j in range(2))
    want = tnn.multihead_attention(torch.from_numpy(qe).permute(1, 0, 2), k,
                                   v, num_heads=h).permute(1, 0, 2)
    ec.lc._close(out.asnumpy(), want.numpy(), 1e-5)


@pytest.mark.cuda
def test_names_on_the_card(cuda):
    """Every name on the card against the CPU (1e-5 of the largest entry;
    bitwise where the CPU tests are bitwise)."""
    failed = {}
    for name in sorted(ec.EXTRA):
        try:
            ec.check_card(name)
        except Exception as e:  # noqa: BLE001 — collected, then reported
            failed[name] = repr(e)[:200]
    assert not failed, failed
