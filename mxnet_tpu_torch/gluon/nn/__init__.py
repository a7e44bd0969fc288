"""Core layers (the subset the GPT family uses)."""
from .basic_layers import Dense, Embedding, HybridSequential, LayerNorm

__all__ = ["Dense", "Embedding", "HybridSequential", "LayerNorm"]
