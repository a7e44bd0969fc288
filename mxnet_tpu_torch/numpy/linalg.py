"""mx.np.linalg of the port — linear algebra over ``torch.linalg``.

Counterpart of ``mxnet_tpu/numpy/linalg.py``: the same functions over the
``linalg_*`` ops of :mod:`mxnet_tpu_torch.ops._core`. Decompositions whose
factors are defined up to sign (``svd``, ``qr``, ``eigh``) may differ in
those signs from the reference's; their products agree.
"""
from __future__ import annotations

from ..ndarray.ndarray import NDArray, array
from ..ops.registry import apply_op as _op


def _nd(x):
    return x if isinstance(x, NDArray) else array(x)


def norm(x, ord=None, axis=None, keepdims=False):
    return _op("norm", _nd(x), ord=ord,
               axis=tuple(axis) if isinstance(axis, (list, tuple)) else axis,
               keepdims=keepdims)


def inv(a):
    return _op("linalg_inv", _nd(a))


def pinv(a):
    return _op("linalg_pinv", _nd(a))


def det(a):
    return _op("linalg_det", _nd(a))


def slogdet(a):
    return _op("linalg_slogdet", _nd(a))


def cholesky(a):
    return _op("linalg_cholesky", _nd(a))


def qr(a, mode="reduced"):
    return _op("linalg_qr", _nd(a), mode=mode)


def svd(a, full_matrices=True, compute_uv=True):
    return _op("linalg_svd", _nd(a), full_matrices=full_matrices,
               compute_uv=compute_uv)


def eigh(a):
    return _op("linalg_eigh", _nd(a))


def eigvalsh(a):
    return _op("linalg_eigvalsh", _nd(a))


def solve(a, b):
    return _op("linalg_solve", _nd(a), _nd(b))


def lstsq(a, b, rcond=None):
    return _op("linalg_lstsq", _nd(a), _nd(b), rcond=rcond)


def matrix_power(a, n):
    return _op("linalg_matrix_power", _nd(a), n=n)


def matrix_rank(a):
    return _op("linalg_matrix_rank", _nd(a))


def multi_dot(arrays):
    return _op("linalg_multi_dot", *[_nd(a) for a in arrays])


def tensorsolve(a, b, axes=None):
    return _op("linalg_tensorsolve", _nd(a), _nd(b),
               axes=tuple(axes) if axes else None)


def tensorinv(a, ind=2):
    return _op("linalg_tensorinv", _nd(a), ind=ind)
