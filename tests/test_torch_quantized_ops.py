"""PyTorch/CUDA port: the quantized op family (``ops/quantized_ops.py``)
and the ops of ``contrib/quantization.py``, the reference's 43 names with
their ``_contrib_`` aliases, against the JAX package on the CPU.

Each name is a case of one parametrised test, on the inputs of
``tests/torch_quantized_cases.py``: integer outputs (codes, int32
accumulators, pooled codes, embeddings) bitwise, float outputs (ranges,
rescaled products) within ``FLOAT_RTOL`` (1e-6) of the largest entry,
dtypes equal, and the straight-through estimators' and ``intgemm_maxabsolute``'s
gradients within the same bound. The cases' casts feed out-of-range floats
(beyond int8 and int32, infinities, NaN) to every float -> integer cast the
reference makes, which XLA saturates. An alias is checked to be its
target's ``Op`` in both registries and runs its target's first case. The
``cuda`` tests hold the card against the CPU, and the padded integer
product at shapes cuBLASLt's int8 GEMM refuses as they are.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_quantized_cases as qc
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.ops import aliases as taliases
from mxnet_tpu_torch.ops import quantized_ops as tq
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _reference_names(module):
    from mxnet_tpu.ops import registry as jreg

    return {n for n, op in jreg._OPS.items()
            if op._make_fn.__module__ == module}


def test_names_are_the_references():
    """The table holds exactly the reference's names of the two modules
    (38 and 5), the port registers them all, and the alias table all 217
    of its entries."""
    ops = _reference_names("mxnet_tpu.ops.quantized_ops")
    contrib = _reference_names("mxnet_tpu.contrib.quantization")
    assert len(ops) == 38 and len(contrib) == 5
    assert set(qc.ALL) == ops | contrib, sorted(set(qc.ALL) ^ (ops | contrib))
    assert set(qc.CONTRIB) == contrib
    assert set(qc.ALL) <= set(treg.list_ops())
    have = [a for a in taliases.ALIASES if a in treg._OPS]
    assert len(have) == 217 and len(taliases.ALIASES) == 217


@pytest.mark.parametrize("name", sorted(qc.ALL))
def test_name_matches_reference(name):
    if qc.target(name) != name:
        from mxnet_tpu.ops import registry as jreg

        assert treg.get_op(name) is treg.get_op(qc.target(name))
        assert jreg.get_op(name) is jreg.get_op(qc.target(name))
        qc.check_against_reference(name, first=True)
        return
    qc.check_against_reference(name)


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_float_casts_saturate_as_the_reference(dtype):
    """``_sat`` gives XLA's saturating cast (NaN to 0) where torch's
    ``.to`` wraps, and wraps an integer as both do."""
    import jax.numpy as jnp

    x = onp.concatenate([qc._WILD, onp.array(
        [2.0 ** 31, -2.0 ** 31, 1e38, -1e38, 126.9, -127.9], "float32")])
    got = tq._sat(torch.from_numpy(x), getattr(torch, dtype)).numpy()
    onp.testing.assert_array_equal(got, onp.asarray(
        jnp.asarray(x).astype(dtype)))
    i = onp.array([300, -300, 2 ** 31 - 1, 5], "int32")
    got = tq._sat(torch.from_numpy(i), getattr(torch, dtype)).numpy()
    onp.testing.assert_array_equal(got, onp.asarray(
        jnp.asarray(i).astype(dtype)))


def test_constant_divisors_are_reciprocal_products_as_in_xla():
    """The reference's XLA program multiplies by a constant divisor's
    float32 reciprocal (codes of ``quantize_v2`` with a calibrated range,
    of ``contrib_quantize`` with a scale, of ``quantized_fully_connected``'s
    ``act_scale``) and divides by a divisor known at run time; next to
    the half-codes the two differ, and the port takes the reference's."""
    from mxnet_tpu.ops.registry import get_op as jget

    for attrs in ({"scale": 0.0237}, {"scale": 1.7 / 127}):
        # values a few ulps around every half-code: where the two roundings
        # of the quotient fall on either side of it
        s32 = onp.float32(attrs["scale"])
        half = ((onp.arange(-127, 127) + 0.5) * s32).astype("float32")
        x = onp.concatenate([half] + [
            onp.nextafter(half, onp.float32(d * onp.inf)).astype("float32")
            for d in (-1, 1)])
        x = onp.concatenate([x, onp.nextafter(x, onp.float32(onp.inf)),
                             onp.nextafter(x, onp.float32(-onp.inf))])
        want = onp.asarray(jget("contrib_quantize").fn(**attrs)(x)[0])
        got = treg.get_op("contrib_quantize").fn(**attrs)(
            torch.from_numpy(x))[0].numpy()
        onp.testing.assert_array_equal(got, want)
        divided = onp.clip(onp.round(x / s32), -127, 127).astype("int8")
        assert (divided != want).any()


def test_ste_gradients_pass_through_ndarrays():
    """``round_ste``/``sign_ste`` through ``mx.np`` and ``autograd``: the
    gradient arrives unchanged (reference ``tests/test_quantized_ops.py``)."""
    v = tnp.array(onp.array([0.3, -0.7], "float32"))
    v.attach_grad()
    with tmx.autograd.record():
        y = (treg.apply_op("round_ste", v) *
             tnp.array(onp.array([2.0, 3.0], "float32"))).sum()
    y.backward()
    onp.testing.assert_array_equal(v.grad.asnumpy(), [2.0, 3.0])
    w = tnp.array(onp.array([0.3, -0.7], "float32"))
    w.attach_grad()
    with tmx.autograd.record():
        y = treg.apply_op("sign_ste", w).sum()
    y.backward()
    onp.testing.assert_array_equal(w.grad.asnumpy(), [1.0, 1.0])


@pytest.mark.cuda
def test_names_on_the_card(cuda):
    """Every name on the card against the CPU: integer outputs bitwise,
    floats within ``FLOAT_RTOL``."""
    failed = {}
    for name in sorted(qc.ALL):
        try:
            qc.check_card(name)
        except Exception as e:  # noqa: BLE001 — collected, then reported
            failed[name] = repr(e)[:200]
    assert not failed, failed


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 33])
def test_int8_matmul_pads_what_the_gemm_refuses(cuda, m):
    """``torch._int_mm`` wants more than 16 rows and inner and column
    counts that are multiples of 8: the padded product equals the CPU's
    bitwise at every other shape."""
    rs = onp.random.RandomState(m)
    for k, n in ((5, 3), (8, 8), (13, 11), (768, 2304)):
        a = torch.from_numpy(rs.randint(-128, 128, (m, k)).astype("int8"))
        w = torch.from_numpy(rs.randint(-128, 128, (n, k)).astype("int8"))
        got = tq.int8_matmul(a.to(cuda), w.to(cuda))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got.cpu(), tq.int8_matmul(a, w)), (m, k, n)
