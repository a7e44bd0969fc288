"""gluon: blocks, layers, parameters, losses, the Trainer and the model zoo,
as ``torch.nn.Module``s and plain PyTorch."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "DeferredInitializationError", "Trainer", "loss", "nn",
           "model_zoo"]
