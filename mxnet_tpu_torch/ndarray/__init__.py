"""NDArray package of the port: the NDArray type and the sparse arrays
(``sparse``); the legacy op namespace ``mx.nd`` is :mod:`mxnet_tpu_torch.nd`."""
from . import sparse
from .ndarray import NDArray, array, from_torch

__all__ = ["NDArray", "array", "from_torch", "sparse"]
