"""Model zoo of the port: the GPT causal language model family."""
from .gpt import DecoderLayer, GPTModel, gpt2_medium, gpt2_small, gpt_tiny

__all__ = ["DecoderLayer", "GPTModel", "gpt2_small", "gpt2_medium",
           "gpt_tiny"]
