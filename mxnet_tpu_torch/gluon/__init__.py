"""gluon: blocks, layers, parameters, losses, the Trainer and the model zoo,
as ``torch.nn.Module``s and plain PyTorch."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock
from .parameter import Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "Trainer", "loss", "nn",
           "model_zoo"]
