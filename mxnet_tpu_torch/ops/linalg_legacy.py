"""The legacy ``mx.nd.linalg_*`` operator family.

Counterpart of ``mxnet_tpu/ops/linalg_legacy.py`` (reference:
src/operator/tensor/la_op.cc): gemm, gemm2, potrf, potri, trmm, trsm, syrk,
syevd, gelqf, makediag, extractdiag, maketrian, extracttrian, sumlogdiag,
inverse, eig and eigvals over ``torch.linalg``, batched over the leading
axes, with the reference's attributes. The alias table
(:mod:`.aliases`) registers the ``_linalg_*`` names.

The eigenvectors of ``linalg_syevd`` and the factors of ``linalg_gelqf``
are fixed only up to sign, by neither package: each returns what its
library's factorization gives. ``linalg_eig`` and ``linalg_eigvals`` run
where ``torch.linalg.eig`` runs (the reference's run on the CPU only);
where it refuses the tensor's device they raise :class:`MXNetError`.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = []


def _t(x, transpose):
    return x.mT if transpose else x


@register("linalg_gemm")
def _linalg_gemm(transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
                 axis=-2):
    def f(a, b, c):
        return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b)) \
            + beta * c

    return f


@register("linalg_gemm2")
def _linalg_gemm2(transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    def f(a, b):
        return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b))

    return f


@register("linalg_potrf")
def _linalg_potrf(lower=True):
    def f(a):
        ch = torch.linalg.cholesky(a)
        return ch if lower else ch.mT

    return f


@register("linalg_potri")
def _linalg_potri(lower=True):
    """The inverse from a Cholesky factor: ``L^-T L^-1``."""
    def f(l):  # noqa: E741 — the reference's operand name
        lt = l if lower else l.mT
        eye = torch.eye(lt.shape[-1], dtype=lt.dtype,
                        device=lt.device).expand(lt.shape)
        linv = torch.linalg.solve_triangular(lt, eye, upper=False)
        return torch.matmul(linv.mT, linv)

    return f


@register("linalg_trmm")
def _linalg_trmm(transpose=False, rightside=False, lower=True, alpha=1.0):
    def f(a, b):
        tri = _t(torch.tril(a) if lower else torch.triu(a), transpose)
        return alpha * (torch.matmul(b, tri) if rightside
                        else torch.matmul(tri, b))

    return f


@register("linalg_trsm")
def _linalg_trsm(transpose=False, rightside=False, lower=True, alpha=1.0):
    """``alpha * op(A)^-1 B`` (``B op(A)^-1`` with ``rightside``), ``op``
    the transpose where asked, ``A`` the ``lower`` or upper triangle."""
    def f(a, b):
        tri = _t(torch.tril(a) if lower else torch.triu(a), transpose)
        return alpha * torch.linalg.solve_triangular(
            tri, b, upper=lower == transpose, left=not rightside)

    return f


@register("linalg_syrk")
def _linalg_syrk(transpose=False, alpha=1.0):
    def f(a):
        return alpha * (torch.matmul(a.mT, a) if transpose
                        else torch.matmul(a, a.mT))

    return f


@register("linalg_syevd", nout=2)
def _linalg_syevd():
    def f(a):
        w, v = torch.linalg.eigh(a)
        # (U, lambda) with the rows of U the eigenvectors, as the reference
        return v.mT, w

    return f


@register("linalg_gelqf", nout=2)
def _linalg_gelqf():
    """The LQ factorization ``A = L Q``, from the QR of ``A^T``."""
    def f(a):
        q, r = torch.linalg.qr(a.mT, mode="reduced")
        return r.mT, q.mT

    return f


@register("linalg_makediag")
def _linalg_makediag(offset=0):
    return lambda a: torch.diag_embed(a, offset=offset)


@register("linalg_extractdiag")
def _linalg_extractdiag(offset=0):
    return lambda a: torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register("linalg_maketrian")
def _linalg_maketrian(offset=0, lower=True):
    """A vector packed row by row into the lower (or upper) triangle.

    Only the main-diagonal packing (offset=0) is implemented, as in the
    reference: a wrong-size answer for banded offsets would be worse than an
    error."""
    if offset != 0:
        raise MXNetError("linalg_maketrian: offset != 0 is not supported")

    def f(a):
        n_elem = a.shape[-1]
        n = int((-1 + (1 + 8 * n_elem) ** 0.5) / 2)
        idx = (torch.tril_indices if lower else torch.triu_indices)(
            n, n, device=a.device)
        flat = a.reshape(-1, n_elem)
        out = torch.zeros(flat.shape[0], n * n, dtype=a.dtype,
                          device=a.device).index_copy(1, idx[0] * n + idx[1],
                                                      flat)
        return out.reshape(a.shape[:-1] + (n, n))

    return f


@register("linalg_extracttrian")
def _linalg_extracttrian(offset=0, lower=True):
    def f(a):
        n = a.shape[-1]
        idx = (torch.tril_indices if lower else torch.triu_indices)(
            n, n, offset, device=a.device)
        return a[..., idx[0], idx[1]]

    return f


@register("linalg_sumlogdiag")
def _linalg_sumlogdiag():
    return lambda a: torch.sum(
        torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), -1)


@register("linalg_inverse")
def _linalg_inverse():
    return torch.linalg.inv


def _eig(name, fn):
    def f(a):
        try:
            return fn(a)
        except (RuntimeError, NotImplementedError) as e:
            raise MXNetError(
                f"{name}: torch.linalg.eig does not run on {a.device} in "
                f"this build of torch ({e})") from e

    return f


# the non-symmetric decompositions: complex outputs, no gradient
register("linalg_eig", lambda **a: _eig(
    "linalg_eig", lambda x: tuple(torch.linalg.eig(x))),
    nout=2, differentiable=False)
register("linalg_eigvals", lambda **a: _eig(
    "linalg_eigvals", torch.linalg.eigvals), differentiable=False)
