"""NDArray package of the port (the reference's ``mx.nd`` here holds only
the NDArray type; the legacy ``mx.nd`` op namespace is not ported)."""
from .ndarray import NDArray, array, from_torch

__all__ = ["NDArray", "array", "from_torch"]
