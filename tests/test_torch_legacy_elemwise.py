"""PyTorch/CUDA port: ``mxnet_tpu_torch/ops/legacy_elemwise.py`` (the
scalar families, the unary extras, the identities with a backward of their
own, the creation ops, the legacy slice family, ``Reshape`` and
``_npx_reshape``, the splits and assignments, the multi-tensor helpers,
``histogram`` and the legacy NN extras) against the JAX package on the CPU.

Each name registered from the reference's ``legacy_elemwise`` is a case of
one parametrised test, on the inputs of ``tests/torch_legacy_cases.py``:
values within 1e-5 of the largest entry (bitwise for integer, index and
creation outputs), dtypes equal, and the inputs' gradients (JAX ``grad``
against torch autograd) within 1e-5 of the largest entry. The scalar
families are held in int32 and bf16 too, bitwise (one rounding of the same
formula on each side). The ``cuda`` test holds the card against the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_legacy_cases as lc
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import np as tnp
from mxnet_tpu_torch.ops import registry as treg



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
    """The table holds exactly the names the reference registers from
    ``legacy_elemwise`` (its own and their aliases), and the port
    registers every one."""
    names = _reference_names("legacy_elemwise")
    assert set(lc.LEGACY) == names, sorted(set(lc.LEGACY) ^ names)
    # the 153 names this slice ports, and ones_like, zeros_like and
    # _npi_ones_like, which _core had
    assert len(names) == 156
    assert names <= set(treg.list_ops())


def test_cases_follow_the_sweep():
    """Where ``tests/test_op_sweep.py`` has a spec, the first case here has
    its attributes and its inputs' shapes and dtypes."""
    import test_op_sweep as sweep

    shared = sorted(set(lc.LEGACY) & set(sweep.SPECS))
    assert len(shared) > 60
    for name in shared:
        build, attrs, _, _ = sweep.SPECS[name]
        mine = lc.cases(name)[0]
        if name == "identity":
            continue
        assert mine[1] == attrs, (name, mine[1], attrs)
        want = [onp.asarray(a) for a in build()]
        got = lc.inputs(name, 0)
        assert [a.shape for a in got] == [a.shape for a in want], name
        assert [a.dtype.kind for a in got] == [a.dtype.kind for a in want], \
            name
    for name in sorted(sweep._SCALAR_TABLE) + sorted(sweep._SCALAR_INT_TABLE):
        assert lc.cases(name)[0][1]["scalar"] == (
            2 if name in sweep._SCALAR_INT_TABLE else sweep._S), name


@pytest.mark.parametrize("name", sorted(lc.LEGACY))
def test_matches_reference(name):
    lc.check_against_reference(name)
    if isinstance(lc.LEGACY[name], str):
        from mxnet_tpu.ops import registry as jreg

        assert treg.get_op(name) is treg.get_op(lc.target(name))
        assert jreg.get_op(name) is jreg.get_op(lc.target(name))


_DTYPED = [(n, dt) for n in lc.SCALAR_OPS + lc.SCALAR_CMP
           for dt in ("int32", "bfloat16")] + \
    [(n, "int32") for n in lc.SCALAR_INT_OPS]


@pytest.mark.parametrize("name,dtype", _DTYPED)
def test_scalar_family_dtypes(name, dtype):
    """int32 and bf16 inputs: the reference's weak typing decides the
    result's dtype (int32 with a float scalar gives float32, bf16 stays
    bf16); values bitwise."""
    from mxnet_tpu.ops import registry as jreg
    import jax.numpy as jnp

    from mxnet_tpu_torch.base import dtype_name

    rng = onp.random.RandomState(len(name))
    x = lc._scalar_input(rng, dtype if dtype == "int32" else "float32",
                         ties=name in lc.SCALAR_CMP)
    scalar = 2 if name in lc.SCALAR_INT_OPS else lc.S
    if name in ("_rmod_scalar", "_npi_rfmod_scalar") and dtype == "int32":
        scalar = 7          # an integer divisor of 0 is undefined in both
    jx = jnp.asarray(x).astype(dtype)
    want = jreg.get_op(name).fn(scalar=scalar)(jx)
    tx = torch.from_numpy(x).to(tmx.base.to_dtype(dtype))
    got = treg.get_op(name).fn(scalar=scalar)(tx)
    assert dtype_name(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    onp.testing.assert_array_equal(
        got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy(),
        onp.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16
                    else want))


_RESHAPE = [((2, 3, 4), (0, -1)), ((2, 3, 4), (-1, 0)),
            ((2, 3, 4), (-2,)), ((2, 3, 4), (0, -2)),
            ((2, 3, 4), (-3, 4)), ((2, 3, 4), (-3, -2)),
            ((2, 3, 4), (0, -4, 1, 3, 4)), ((2, 12), (0, -4, -1, 4)),
            ((2, 12), (0, -4, 3, -1)), ((2, 3, 4), (4, 0, -1)),
            ((2, 3, 4, 5), (-3, -3)), ((8, 5), (-1, 4), True),
            ((2, 3, 4), (0, -1), True), ((6, 4), (0, 2, -1))]
_NPX_RESHAPE = [((2, 1, 3, 4), (-2, -3, -2, -2)), ((2, 1, 3, 4), (-2, -4)),
                ((2, 1, 3, 4), (2, -4)), ((2, 1, 3, 4), (-5, -5)),
                ((2, 1, 3, 4), (-2, -2, -2, -6, 2, -1)),
                ((2, 1, 3, 4), (-2, -2, -6, -1, 1, -2)),
                ((8, 5), (-1, 4), True), ((2, 3, 4), (-1, -2), True),
                ((2, 3, 4), (6, -1)), ((2, 3, 4), (-4,))]


@pytest.mark.parametrize("case", _RESHAPE + [("npx",) + c
                                             for c in _NPX_RESHAPE])
def test_reshape_codes(case):
    """``Reshape``'s codes 0, -1, -2, -3, -4 and ``reverse``, and
    ``_npx_reshape``'s -1 to -6, case by case, against the reference."""
    from mxnet_tpu.ops import registry as jreg
    import jax.numpy as jnp

    npx = case[0] == "npx"
    src, spec, *rev = case[1:] if npx else case
    name, key = ("_npx_reshape", "newshape") if npx else ("Reshape", "shape")
    attrs = {key: spec, "reverse": bool(rev)}
    x = onp.arange(int(onp.prod(src)), dtype="float32").reshape(src)
    want = jreg.get_op(name).fn(**attrs)(jnp.asarray(x))
    got = treg.get_op(name).fn(**attrs)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))


def test_npx_reshape_refuses_a_skip_of_a_wide_dim():
    x = tnp.array(onp.zeros((2, 3), "float32"))
    with pytest.raises(ValueError):
        treg.apply_op("_npx_reshape", x, newshape=(-3, -4))


@pytest.mark.parametrize("name", ["_slice_assign", "_slice_assign_scalar",
                                  "_scatter_set_nd", "scatter_nd"])
def test_assignments_are_functional(name):
    """Each assignment returns a new tensor and leaves its input as it
    was, as the reference's ``.at[].set``."""
    ins = [torch.from_numpy(a) for a in lc.inputs(name, 0)]
    before = [t.clone() for t in ins]
    out = treg.get_op(name).fn(**lc.cases(name)[0][1])(*ins)
    for t, b in zip(ins, before):
        assert torch.equal(t, b)
        assert out.data_ptr() != t.data_ptr()


def test_identity_backwards_are_the_references():
    """``MakeLoss`` seeds ``grad_scale`` whatever gradient arrives (with or
    without head gradients), ``gradientmultiplier`` scales it and
    ``IdentityAttachKLSparseReg`` adds the KL penalty of the batch mean,
    as the reference's custom VJPs, through ``mx.nd`` and autograd."""
    import mxnet_tpu as mx

    x0 = onp.abs(onp.random.RandomState(3).randn(3, 4)).astype("float32")
    for name, attrs in [("MakeLoss", {"grad_scale": 0.5}),
                        ("gradientmultiplier", {"scalar": -2.0}),
                        ("IdentityAttachKLSparseReg",
                         {"sparseness_target": 0.3, "penalty": 0.1})]:
        grads = []
        for pkg, arr in ((mx, mx.np.array), (tmx, tnp.array)):
            for head in (None, 3.0):
                x = arr(x0)
                x.attach_grad()
                with pkg.autograd.record():
                    y = getattr(pkg.nd, name)(x, **attrs) * 2.0
                y.backward(None if head is None else arr(
                    onp.full((3, 4), head, "float32")))
                grads.append(x.grad.asnumpy())
        want_none, want_head, got_none, got_head = grads
        onp.testing.assert_allclose(got_none, want_none, rtol=1e-6)
        onp.testing.assert_allclose(got_head, want_head, rtol=1e-6)
        if name == "MakeLoss":
            onp.testing.assert_array_equal(got_none, got_head)
            assert (got_none == 0.5).all()


def test_creation_ops_land_on_the_context():
    """A creation op has no operand: it lands on ``ctx`` or on the current
    context, resolved at each call (the cached function serves both)."""
    out = tnd.zeros(shape=(2, 2))
    assert out._data.device.type == "cpu"
    assert tnd.arange(start=3)._data.device.type == "cpu"
    assert tnd.eye(N=2, ctx=tmx.cpu())._data.device.type == "cpu"


def test_legacy_names_resolve():
    for name in ["LRN", "Reshape", "SliceChannel", "MakeLoss", "_mul_scalar",
                 "SwapAxis", "rsqrt", "ElementWiseSum", "SoftmaxActivation"]:
        assert callable(getattr(tnd, name)), name
        assert callable(getattr(tmx.sym, name)), name
    x = tnp.array(onp.arange(6, dtype="float32").reshape(2, 3))
    assert tnd.SwapAxis(x, dim1=0, dim2=1).shape == (3, 2)
    onp.testing.assert_allclose(tnd.rsqrt(x + 1).asnumpy(),
                                1 / onp.sqrt(x.asnumpy() + 1), rtol=1e-6)


def test_sync_batch_norm_refuses_a_mesh_axis():
    with pytest.raises(tmx.base.MXNetError, match="A8"):
        treg.get_op("sync_batch_norm").fn(axis_name="dp")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(lc.LEGACY))
def test_on_card_matches_cpu(cuda, name):
    lc.check_card(name)
