"""mx.np.save / load / savez of the port — numpy's .npy/.npz wire format.

Counterpart of ``mxnet_tpu/numpy/_serialization.py``: arrays are copied to
the host and written with numpy's own writer, which is the wire format, so
files round-trip with stock ``numpy.load`` and with the reference.

bfloat16 is saved as float32 (value-exact, loadable everywhere), as the
reference does by default. :func:`load` also reads the reference's raw
bfloat16 payload (written under its ``MXTPU_NPY_BF16=raw``, which numpy
reads back as 2-byte void, ``|V2``) as bfloat16. Loaded arrays get the
reference's dtypes: 64-bit data is narrowed to 32 bits.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..base import MXNetError, narrow
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["save", "savez", "savez_compressed", "load"]


def _to_host(a):
    if isinstance(a, NDArray):
        t = a._data.detach()
        return t.float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else a.asnumpy()
    a = _onp.asarray(a)
    return a.astype(_onp.float32) if a.dtype.name == "bfloat16" else a


def save(file, arr):
    """Write one array as .npy (numpy wire format)."""
    _onp.save(file, _to_host(arr))


def savez(file, *args, **kwds):
    """Write arrays as an uncompressed .npz archive."""
    _onp.savez(file, *[_to_host(a) for a in args],
               **{k: _to_host(v) for k, v in kwds.items()})


def savez_compressed(file, *args, **kwds):
    """Write arrays as a zip-deflated .npz archive."""
    _onp.savez_compressed(file, *[_to_host(a) for a in args],
                          **{k: _to_host(v) for k, v in kwds.items()})


def load(file, allow_pickle=False):
    """Read .npy -> NDArray, or .npz -> dict of name -> NDArray, on the
    current context (reference :62). Object arrays are refused."""
    data = _onp.load(file, allow_pickle=allow_pickle)
    dev = current_context().torch_device
    if isinstance(data, _onp.lib.npyio.NpzFile):
        try:
            return {k: NDArray(_decode(data[k]).to(dev)) for k in data.files}
        finally:
            data.close()
    return NDArray(_decode(data).to(dev))


def _decode(a):
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        # raw-mode bfloat16 payload (see module docstring)
        return torch.from_numpy(a.view(_onp.int16).copy()).view(
            torch.bfloat16)
    if a.dtype == _onp.object_:
        raise MXNetError("object arrays are not loadable as NDArray")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(_onp.float32)).to(torch.bfloat16)
    return narrow(torch.from_numpy(_onp.array(a, copy=True)))
