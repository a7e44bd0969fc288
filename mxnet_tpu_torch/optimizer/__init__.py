"""Optimizer package (reference: ``mxnet_tpu/optimizer/``)."""
from .optimizer import (NAG, SGD, Adam, AdamW, Optimizer, create,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "create",
           "register"]
