"""``mx.contrib`` of the port (reference ``mxnet_tpu/contrib/__init__.py``):
:mod:`.quantization`. The reference's other submodules are ROADMAP items
of their own: reaching ``onnx`` raises :class:`MXNetError` naming A10 (4),
``text``, ``tensorboard`` or ``tensorrt`` naming A10 (5)."""
from ..base import MXNetError
from . import quantization

_LATER = {"onnx": "A10 (4)", "text": "A10 (5)", "tensorboard": "A10 (5)",
          "tensorrt": "A10 (5)"}

__all__ = ["quantization"]


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(f"mx.contrib.{name} is not ported yet (ROADMAP "
                         f"{_LATER[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
