"""Model zoo of the port: the GPT causal language model family, the BERT
encoder family, the LSTM language model (``rnn_lm``) and the vision models
(ResNet v1/v2, AlexNet, VGG, the MLP, DenseNet, MobileNet v1/v2,
SqueezeNet, Inception v3 and SSD)."""
from . import bert, rnn_lm, vision
from .bert import (BERTEncoder, BERTForPretraining, BERTModel,
                   TransformerEncoderLayer, bert_base, bert_large)
from .gpt import DecoderLayer, GPTModel, gpt2_medium, gpt2_small, gpt_tiny
from .rnn_lm import RNNModel
from .vision import get_model

__all__ = ["DecoderLayer", "GPTModel", "gpt2_small", "gpt2_medium",
           "gpt_tiny", "bert", "TransformerEncoderLayer", "BERTEncoder",
           "BERTModel", "BERTForPretraining", "bert_base", "bert_large",
           "vision", "get_model", "rnn_lm", "RNNModel"]
