"""gluon: blocks, layers, recurrent cells and layers (``gluon.rnn``),
parameters, losses, the Trainer, the model zoo, the input pipeline
(``gluon.data``) and the detection transforms and loaders of
``gluon.contrib.data.vision``, as ``torch.nn.Module``s and plain PyTorch."""
from . import data, loss, model_zoo, nn, rnn
from . import contrib
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "Constant",
           "DeferredInitializationError", "Trainer", "data", "loss", "nn",
           "rnn", "model_zoo", "contrib"]
