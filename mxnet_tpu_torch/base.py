"""Base utilities of the PyTorch/CUDA port: the framework error type.

Counterpart of ``mxnet_tpu/base.py``. Only what the serving slice needs is
carried: :class:`MXNetError`, the exception every layer of the port raises,
and the dtype-name helper.
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "to_dtype"]


class MXNetError(RuntimeError):
    """Framework error type (reference: MXGetLastError / dmlc::Error)."""


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def to_dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None
