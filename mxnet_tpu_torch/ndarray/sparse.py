"""Sparse NDArrays of the port: CSR and row-sparse.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (CSRNDArray :39,
RowSparseNDArray :155, ``csr_matrix``, ``row_sparse_array``, ``dot``). Both
formats are dense tensors on the array's device:

- ``CSRNDArray``: ``data`` (nnz,), ``indices`` (nnz,) int32 and ``indptr``
  (rows + 1,) int32 as NDArrays, plus a host copy of ``indptr``, so that
  ``slice`` cuts the three on the device without reading anything back.
  The per-entry row ids (``_rows``) are expanded from ``indptr`` on the
  device once (``torch.repeat_interleave`` with the known ``nnz`` as its
  output size: no host sync). ``dot`` (CSR x dense) is the registered
  ``dot_csr`` op: a gather, a multiply and a segment sum
  (``index_add``), recorded by autograd, so the dense operand gets its
  gradient without the matrix ever being densified.
- ``RowSparseNDArray``: ``data`` (rows stored, ...) and ``indices``
  (rows stored,) int32, the format of embedding gradients and of the
  optimizers' lazy updates (:mod:`mxnet_tpu_torch.ops.optimizer_ops`).

Writes with duplicate coordinates keep the last one, as the reference's
scatter (``.at[].set``) does on the CPU.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError, canonical_dtype
from ..context import resolve_device
from ..ops._core import last_wins
from .ndarray import NDArray

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix",
           "row_sparse_array", "BaseSparseNDArray", "dot"]


def _device_of(*xs, ctx=None):
    """``ctx`` resolved, else the device of the first tensor or NDArray
    among ``xs``, else the current context's."""
    if ctx is not None:
        return resolve_device(ctx)
    for x in xs:
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


def _tensor(x, dtype, dev):
    """``x`` (NDArray, tensor or array-like) as a tensor on ``dev``; a
    tensor already there with the dtype is taken as it is."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype or x.dtype)
    host = onp.asarray(x)
    t = torch.from_numpy(onp.ascontiguousarray(host))
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    return t.to(device=dev, dtype=dtype or t.dtype)


class BaseSparseNDArray:
    @property
    def stype(self):
        raise NotImplementedError

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ctx(self):
        return self.data.ctx

    context = ctx

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype):
        raise NotImplementedError


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix on a device (see the module docstring).
    ``indptr_host`` (numpy) may be given where the caller has it, so that
    nothing is read back from the device; else it is copied once."""

    def __init__(self, data, indices, indptr, shape, ctx=None,
                 indptr_host=None):
        dev = _device_of(data, indices, indptr, ctx=ctx)
        self.data = NDArray(_tensor(data, None, dev))
        self.indices = NDArray(_tensor(indices, torch.int32, dev))
        self.indptr = NDArray(_tensor(indptr, torch.int32, dev))
        if indptr_host is None:
            indptr_host = indptr._data if isinstance(indptr, NDArray) \
                else indptr
            indptr_host = indptr_host.cpu().numpy() if isinstance(
                indptr_host, torch.Tensor) else onp.asarray(indptr_host)
        self._indptr_host = onp.asarray(indptr_host, dtype=onp.int64)
        self._shape = tuple(int(s) for s in shape)
        self._row_ids = None

    @property
    def stype(self):
        return "csr"

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def _rows(self) -> NDArray:
        """Per-entry row ids (nnz,) int32, expanded from ``indptr`` on the
        device once."""
        if self._row_ids is None:
            ip = self.indptr._data
            self._row_ids = NDArray(torch.repeat_interleave(
                torch.arange(self._shape[0], dtype=torch.int32,
                             device=ip.device),
                ip[1:] - ip[:-1], output_size=self.nnz))
        return self._row_ids

    def todense(self) -> NDArray:
        """The dense matrix; entries whose column lies outside the shape
        are dropped (the reference's ``mode="drop"``)."""
        rows, cols = self._shape
        vals = self.data._data
        flat = self._rows()._data.long() * cols + self.indices._data.long()
        flat = torch.where(self.indices._data < cols, flat, rows * cols)
        src = last_wins(flat, rows * cols + 1)
        out = torch.zeros(rows * cols + 1, dtype=vals.dtype,
                          device=vals.device)
        out[flat] = vals[src]
        return NDArray(out[:-1].reshape(rows, cols))

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == "csr":
            return self
        raise MXNetError(f"cannot convert csr to {stype}")

    def dot(self, other, transpose_a=False):
        """CSR x dense on the device (the ``dot_csr`` op); ``transpose_a``
        computes A^T other without materialising A^T."""
        return dot(self, other, transpose_a=transpose_a)

    def slice(self, start, stop):
        """Rows [start, stop), cut on the device from the host copy of
        ``indptr``: nothing is read back."""
        ip = self._indptr_host
        lo, hi = int(ip[start]), int(ip[stop])
        return CSRNDArray(self.data._data[lo:hi], self.indices._data[lo:hi],
                          self.indptr._data[start:stop + 1] - lo,
                          (stop - start, self._shape[1]),
                          indptr_host=ip[start:stop + 1] - lo)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(key.start or 0, key.stop or self._shape[0])
        if isinstance(key, int):
            return self.slice(key, key + 1).todense().reshape(
                (self._shape[1],))
        raise MXNetError("csr supports int/slice indexing only")

    def __repr__(self):
        return (f"<CSRNDArray {self._shape} nnz={self.nnz} "
                f"dtype={self.dtype}>")


def dot(lhs, rhs, transpose_a=False):
    """``mx.nd.sparse.dot``: CSR x dense on the device, through the
    registered ``dot_csr`` op, so autograd records the product and the
    dense operand receives its gradient."""
    if not isinstance(lhs, CSRNDArray):
        raise MXNetError("sparse.dot: lhs must be a CSRNDArray")
    from ..ops.registry import apply_op

    rhs_nd = rhs if isinstance(rhs, NDArray) else NDArray(
        _tensor(rhs, None, lhs.data._data.device))
    n_out = lhs.shape[1] if transpose_a else lhs.shape[0]
    return apply_op("dot_csr", lhs.data, lhs.indices, lhs._rows(), rhs_nd,
                    num_rows=n_out, transpose_a=transpose_a)


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: ``indices`` name the stored rows, ``data`` holds
    them (the embedding-gradient format)."""

    def __init__(self, data, indices, shape, ctx=None):
        dev = _device_of(data, indices, ctx=ctx)
        self.data = data if isinstance(data, NDArray) and ctx is None \
            else NDArray(_tensor(data, None, dev))
        self.indices = NDArray(_tensor(indices, torch.int32, dev))
        self._shape = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "row_sparse"

    def todense(self) -> NDArray:
        vals, idx = self.data._data, self.indices._data
        out = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        out[idx.long()] = vals[last_wins(idx, self._shape[0])]
        return NDArray(out)

    def tostype(self, stype):
        if stype == "default":
            return self.todense()
        if stype == "row_sparse":
            return self
        raise MXNetError(f"cannot convert row_sparse to {stype}")

    def retain(self, row_ids):
        """The stored rows listed in ``row_ids`` (intersection, no
        densification); the kept count is data-dependent, so it is read
        back, as the reference reads it."""
        stored = self.indices._data
        rid = _tensor(row_ids, torch.int32, stored.device)
        keep = torch.nonzero(torch.isin(stored, rid)).reshape(-1)
        return RowSparseNDArray(NDArray(self.data._data[keep]),
                                NDArray(stored[keep]), self._shape)

    def __repr__(self):
        return (f"<RowSparseNDArray {self._shape} "
                f"rows={self.indices.shape[0]} dtype={self.dtype}>")


def _dense_of(arg1, dtype, ctx):
    """(tensor, device) of a dense operand of the creation functions."""
    dev = _device_of(arg1, ctx=ctx)
    return _tensor(arg1, canonical_dtype(dtype), dev), dev


def csr_matrix(arg1, shape=None, dtype="float32", ctx=None):
    """A CSRNDArray from ``(data, indices, indptr)`` with ``shape``, or from
    a dense 2-D array (its nonzeros in row-major order)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        dev = _device_of(data, indices, indptr, ctx=ctx)
        return CSRNDArray(_tensor(data, canonical_dtype(dtype), dev),
                          indices, indptr, shape, ctx=dev)
    dense, dev = _dense_of(arg1, dtype, ctx)
    rows, cols = torch.nonzero(dense, as_tuple=True)
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape, ctx=dev)


def row_sparse_array(arg1, shape=None, dtype="float32", ctx=None):
    """A RowSparseNDArray from ``(data, indices)`` with ``shape``, or from a
    dense array (its rows holding any nonzero)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        dev = _device_of(data, indices, ctx=ctx)
        return RowSparseNDArray(_tensor(data, canonical_dtype(dtype), dev),
                                indices, shape, ctx=dev)
    dense, dev = _dense_of(arg1, dtype, ctx)
    mask = (dense != 0).reshape(dense.shape[0], -1).any(dim=1)
    idx = torch.nonzero(mask).reshape(-1)
    return RowSparseNDArray(dense[idx], idx, dense.shape, ctx=dev)
