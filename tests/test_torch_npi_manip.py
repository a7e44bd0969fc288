"""PyTorch/CUDA port: ``mxnet_tpu_torch/ops/npi_manip.py`` (``unique``,
``nonzero``, ``boolean_mask`` and the mask assignments, ``delete``, the
``_npi_insert_*``, ``advanced_indexing*``, ``Concat``, ``hawkesll``,
``mrcnn_mask_target``, ``rroi_align`` and ``calibrate_entropy``) against
the JAX package on the CPU.

Each name is a case of one parametrised test on the inputs of
``tests/torch_legacy_cases.py``: values within 1e-5 of the largest entry
(bitwise for index and selection outputs), dtypes equal, and ``hawkesll``'s
and ``Concat``'s gradients within 1e-5 of the largest entry.

The ops whose output shape follows their operands' values run eagerly and
raise ``MXNetError`` naming themselves inside a compiled program: a
hybridized block and a Symbol's Executor here on the CPU, exactly where the
JAX package's ``jit`` refuses them, and a CUDA graph capture on the card.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_legacy_cases as lc
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_names_are_the_references():
    """The table holds the reference's ``npi_manip`` names less ``Custom``
    (ROADMAP A10 (2)) and the control-flow ops (numpy_extension.control_flow),
    and the port registers every one."""
    from mxnet_tpu.ops import registry as jreg

    names = {n for n, op in jreg._OPS.items()
             if op._make_fn.__module__ == "mxnet_tpu.ops.npi_manip"}
    names -= {"Custom", "_foreach", "_while_loop", "_cond"}
    assert set(lc.NPI) == names, sorted(set(lc.NPI) ^ names)
    assert len(names) == 27 and names <= set(treg.list_ops())
    assert "Custom" not in treg.list_ops()


def test_cases_follow_the_reference_tests():
    """The first cases are ``tests/test_npi_manip_ops.py``'s inputs."""
    assert lc.inputs("unique", 0)[0].tolist() == [3, 1, 2, 2, 3, 3]
    assert lc.inputs("nonzero", 0)[0].tolist() == [[1, 0, 2], [0, 3, 0]]
    data, mask = lc.inputs("boolean_mask", 0)
    assert data.tolist() == onp.arange(12).reshape(4, 3).tolist() and \
        mask.tolist() == [1, 0, 1, 0]
    assert lc.cases("delete")[1][1] == {"start": 1, "stop": 5, "step": 2}
    assert lc.cases("_npi_insert_slice")[0][1] == {"start": 0, "stop": 6,
                                                   "step": 2}
    assert [a.tolist() for a in lc.inputs("_npi_insert_tensor", 0)] == \
        [[0, 1, 2, 3, 4, 5], [8.0, 9.0], [1, 3]]


@pytest.mark.parametrize("name", sorted(lc.NPI))
def test_matches_reference(name):
    lc.check_against_reference(name)


class _Call:
    """A block whose forward is one call of a registered op."""

    def __init__(self, pkg, name, attrs):
        base = pkg.gluon.HybridBlock
        apply_op = pkg.ops.registry.apply_op

        class Block(base):
            def forward(self, *xs):
                return apply_op(name, *xs, **attrs)

        self.block = Block()
        self.block.initialize()
        self.block.hybridize()


_CAPTURE = lc.DATA_DEPENDENT + ["histogram", "_npi_boolean_mask_assign_scalar",
                                "_npx_constraint_check", "Concat"]


def _capture_case(name):
    i = 2 if name == "histogram" else 0        # the edges-input form
    return lc.inputs(name, i), lc.cases(name)[i][1]


@pytest.mark.parametrize("name", _CAPTURE)
def test_refused_in_a_hybridized_block_where_the_reference_is(name):
    """In a hybridized block on the CPU the port raises ``MXNetError``
    naming the op exactly where the JAX package's ``jit`` refuses it; the
    ops of static shape run in both."""
    import mxnet_tpu as mx

    ins, attrs = _capture_case(name)
    try:
        _Call(mx, name, attrs).block(*[mx.np.array(a) for a in ins])
        refused = False
    except Exception:  # noqa: BLE001 — JAX's tracer errors
        refused = True
    assert refused == (name in lc.DATA_DEPENDENT)
    blk = _Call(tmx, name, attrs).block
    args = [tmx.np.array(a) for a in ins]
    if refused:
        with pytest.raises(MXNetError, match=f"op '{name}'"):
            blk(*args)
    else:
        blk(*args)
    # eagerly, the same call runs
    treg.apply_op(name, *args, **attrs)


def test_refused_in_an_executor():
    """A Symbol's Executor runs its graph as a CachedOp body: a
    data-dependent op there raises, as in the reference."""
    import mxnet_tpu as mx

    x = onp.array([[1, 0, 2], [0, 3, 0]], "float32")
    for pkg, err in ((mx, Exception), (tmx, MXNetError)):
        s = pkg.sym.nonzero(pkg.sym.var("x"))
        with pytest.raises(err):
            s.bind(args={"x": pkg.np.array(x)}).forward()


def test_npx_and_nd_doors_resolve():
    x = tmx.np.array(onp.arange(12, dtype="float32").reshape(4, 3))
    m = tmx.np.array(onp.array([1, 0, 1, 0], "float32"))
    got = tmx.npx.boolean_mask(x, m)
    assert got.asnumpy().tolist() == [[0, 1, 2], [6, 7, 8]]
    assert tnd.boolean_mask(x, m).shape == (2, 3)
    assert tmx.npx.nonzero(m).asnumpy().tolist() == [[0], [2]]
    # mx.nd.Concat is _LEGACY_NAMES' concatenate (``axis``), as in the
    # reference; the registry's Concat takes ``dim``
    assert tnd.Concat(x, x, axis=1).shape == (4, 6)
    assert treg.apply_op("Concat", x, x, dim=1).shape == (4, 6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(lc.NPI))
def test_on_card_matches_cpu(cuda, name):
    lc.check_card(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", lc.DATA_DEPENDENT)
def test_refused_inside_a_capture(cuda, name):
    """Inside a CUDA graph capture each data-dependent op raises
    ``MXNetError`` naming itself, before it launches anything; eagerly on
    the card it runs (``test_on_card_matches_cpu``)."""
    ins = [torch.from_numpy(a).cuda() for a in lc.inputs(name, 0)]
    f = treg.get_op(name).fn(**lc.cases(name)[0][1])
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        with pytest.raises(MXNetError, match=f"op '{name}'"):
            with torch.cuda.graph(g, stream=stream):
                f(*ins)
    torch.cuda.synchronize()
