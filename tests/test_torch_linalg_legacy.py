"""PyTorch/CUDA port: ``mxnet_tpu_torch/ops/linalg_legacy.py`` (the
``linalg_*`` family and its ``_linalg_*``/``_npi_eig*`` names) against the
JAX package on the CPU.

Each name is a case of one parametrised test on the inputs of
``tests/torch_legacy_cases.py``: values and gradients within 1e-5 of the
largest entry, and 1e-4 for the factorizations (inputs of condition number
below 100). Neither package fixes the sign of ``linalg_syevd``'s
eigenvectors or of ``linalg_gelqf``'s factors, nor the phase of
``linalg_eig``'s eigenvectors, so those are held by reconstruction
(``U^T diag(w) U = A`` with ``U U^T = I``; ``L Q = A`` with ``Q Q^T = I``
and ``L`` lower triangular; ``A V = V diag(w)``), their eigenvalues
directly, and their gradients through sign-free functions of the factors.
The ``cuda`` test holds the card against the CPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
import torch_legacy_cases as lc
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


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


def test_names_are_the_references():
    """The table holds exactly the reference's names of these ops (its own,
    the fifteen ``_linalg_*`` of the alias table and ``_npi_eig``/
    ``_npi_eigvals``), and the port registers every one."""
    from mxnet_tpu.ops import registry as jreg

    names = {n for n, op in jreg._OPS.items()
             if op._make_fn.__module__ == "mxnet_tpu.ops.linalg_legacy"}
    assert set(lc.LINALG) == names, sorted(set(lc.LINALG) ^ names)
    assert len(names) == 34 and names <= set(treg.list_ops())


def test_cases_follow_the_sweep():
    import test_op_sweep as sweep

    for name in sorted(set(lc.LINALG) & set(sweep.SPECS)):
        build, attrs, _, _ = sweep.SPECS[name]
        mine = lc.cases(name)[0]
        assert mine[1] == attrs, (name, mine[1], attrs)
        want = [onp.asarray(a) for a in build()]
        assert [a.shape for a in lc.inputs(name, 0)] == \
            [a.shape for a in want], name


@pytest.mark.parametrize("name", sorted(lc.LINALG))
def test_matches_reference(name):
    lc.check_against_reference(name)


def test_gemm2_under_amp_matches_reference():
    """``linalg_gemm2`` is on both packages' AMP cast list: under
    ``amp.autocast("bfloat16")`` its float32 operands are cast at entry and
    the product comes back bf16, the same bits on both sides."""
    import mxnet_tpu as mx

    rng = onp.random.RandomState(5)
    a, b = rng.randn(2, 8, 16).astype("float32"), \
        rng.randn(2, 16, 4).astype("float32")
    with mx.amp.autocast("bfloat16"):
        want = mx.nd.linalg_gemm2(mx.np.array(a), mx.np.array(b), alpha=0.5)
    with tamp.autocast("bfloat16"):
        got = tnd.linalg_gemm2(tmx.np.array(a), tmx.np.array(b), alpha=0.5)
    assert str(want.dtype) == "bfloat16" and got._data.dtype == torch.bfloat16
    onp.testing.assert_allclose(got._data.float().numpy(),
                                onp.asarray(want._data.astype("float32")),
                                rtol=2.0 ** -7, atol=0)


def test_maketrian_refuses_an_offset():
    with pytest.raises(tmx.base.MXNetError, match="offset"):
        treg.get_op("linalg_maketrian").fn(offset=1)


def test_linalg_names_resolve():
    for name in ["linalg_gemm2", "_linalg_gemm2", "linalg_potrf",
                 "_linalg_syevd", "_npi_eig"]:
        assert callable(getattr(tnd, name)), name
        assert treg.get_op(name) is treg.get_op(lc.target(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(lc.LINALG))
def test_on_card_matches_cpu(cuda, name):
    """``linalg_eig``/``eigvals`` hold where torch's CUDA build runs
    ``torch.linalg.eig``; elsewhere they raise ``MXNetError`` saying so."""
    try:
        lc.check_card(name)
    except tmx.base.MXNetError as e:
        assert lc.target(name) in ("linalg_eig", "linalg_eigvals") and \
            "torch.linalg.eig does not run" in str(e)
