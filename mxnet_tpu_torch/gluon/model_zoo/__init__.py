"""Model zoo of the port: the GPT causal language model family and the
vision models (ResNet v1/v2)."""
from . import vision
from .gpt import DecoderLayer, GPTModel, gpt2_medium, gpt2_small, gpt_tiny
from .vision import get_model

__all__ = ["DecoderLayer", "GPTModel", "gpt2_small", "gpt2_medium",
           "gpt_tiny", "vision", "get_model"]
