"""gluon.contrib.data: the detection transforms and image loaders
(reference: python/mxnet/gluon/contrib/data)."""
from . import vision

__all__ = ["vision"]
