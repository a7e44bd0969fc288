"""Core layers (the subset GPT and ResNet use)."""
from .basic_layers import (Activation, BatchNorm, Dense, Embedding, Flatten,
                           HybridSequential, LayerNorm)
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all

__all__ = ["Activation", "BatchNorm", "Dense", "Embedding", "Flatten",
           "HybridSequential", "LayerNorm", *_conv_all]
