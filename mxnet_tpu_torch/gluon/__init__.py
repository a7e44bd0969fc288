"""gluon: blocks, layers and the model zoo, as ``torch.nn.Module``s."""
from . import model_zoo, nn
from .block import Block, HybridBlock

__all__ = ["Block", "HybridBlock", "nn", "model_zoo"]
