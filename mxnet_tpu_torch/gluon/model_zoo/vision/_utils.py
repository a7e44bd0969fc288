"""Helpers of the vision zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/_utils.py``)."""
from __future__ import annotations

import contextlib

from ....base import MXNetError


def check_pretrained(kwargs):
    """``pretrained=True`` raises: no weights are fetched; load them from a
    local file with ``load_parameters`` instead."""
    if kwargs.pop("pretrained", False):
        raise MXNetError("no pretrained weights in the zero-egress build; "
                         "load_parameters() from a local file instead")
    return kwargs


def build(cls, *args, **kwargs):
    """``cls(*args, **kwargs)`` after :func:`check_pretrained`, its layers
    made on ``kwargs``' ``ctx`` (the current context when absent)."""
    check_pretrained(kwargs)
    ctx = kwargs.pop("ctx", None)
    with ctx if ctx is not None else contextlib.nullcontext():
        return cls(*args, **kwargs)
