"""BERT encoder family, in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``: the post-LN
transformer layer, the encoder, ``BERTModel`` (embeddings, encoder and
the tanh pooler), ``BERTForPretraining`` (the MLM head tied to the word
embedding, and the NSP classifier), ``bert_base`` and ``bert_large``, with
the reference's parameter names, so ``.params`` files cross between the
packages.

Attention goes through the ``multihead_attention`` op: without
``valid_length`` the flash kernel, and with it the (B, 1, 1, T) key-padding
mask takes the kernel's segment-ids branch (a row of valid length 0 has
every key masked and comes out as zeros). The mask is built on the device
(``arange``, a compare, a cast), with no host sync, so a CUDA graph can
hold it. LayerNorm goes through the fused LayerNorm kernel (eps 1e-12); the
GEMMs are ``torch.matmul``, as the reference computes them outside Pallas.
Dropout is active inside ``autograd.record()`` (or after ``train()``) and
the identity elsewhere. The blocks are torch code (``_tensor_body``) and
read their parameter tensors directly, not through ``Parameter.data()``.
"""
from __future__ import annotations

import torch

from ... import initializer as init_mod
from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ops import nn as F
from .. import nn
from ..block import HybridBlock, new_parameter

__all__ = ["TransformerEncoderLayer", "BERTEncoder", "BERTModel",
           "BERTForPretraining", "bert_base", "bert_large"]


class TransformerEncoderLayer(HybridBlock):
    """Post-LN transformer layer (BERT convention)."""

    _tensor_body = True

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, attention_dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError("units must divide num_heads")
        device = resolve_device(device)
        self._num_heads = num_heads
        w_init = init_mod.Normal(0.02)
        self.attn_qkv = nn.Dense(3 * units, flatten=False, dtype=dtype,
                                 weight_initializer=w_init, in_units=units,
                                 device=device)
        self.attn_proj = nn.Dense(units, flatten=False, dtype=dtype,
                                  weight_initializer=w_init, in_units=units,
                                  device=device)
        self.attn_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                    device=device)
        self.ffn_1 = nn.Dense(hidden_size, flatten=False, dtype=dtype,
                              weight_initializer=w_init, in_units=units,
                              device=device)
        self.ffn_2 = nn.Dense(units, flatten=False, dtype=dtype,
                              weight_initializer=w_init,
                              in_units=hidden_size, device=device)
        self.ffn_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                   device=device)
        self._dropout = dropout

    def forward(self, x, mask=None):
        """``mask``: optional (B, 1, 1, T) key-padding mask (1 = attend)."""
        q, k, v = self.attn_qkv(x).chunk(3, dim=-1)
        attn = F.multihead_attention(q, k, v, mask=mask,
                                     num_heads=self._num_heads)
        attn = F.dropout(self.attn_proj(attn), self._dropout, self.training)
        x = self.attn_ln(x + attn)
        ffn = self.ffn_2(F.leaky_relu(self.ffn_1(x), act_type="gelu"))
        ffn = F.dropout(ffn, self._dropout, self.training)
        return self.ffn_ln(x + ffn)


class BERTEncoder(HybridBlock):
    _tensor_body = True

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout,
                layer_norm_eps=layer_norm_eps, dtype=dtype, device=device))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Embeddings + encoder + pooler. ``forward(inputs, token_types=None,
    valid_length=None)`` returns ``(sequence (B, T, units), pooled (B,
    units))``. ``device``: where the parameters live; None means the GPU
    (and raises without one)."""

    _tensor_body = True

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_eps=1e-12,
                 dtype="float32", device=None):
        super().__init__()
        device = resolve_device(device)
        self.units = units
        self.word_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                       weight_initializer=init_mod.Normal(
                                           0.02), device=device)
        self.token_type_embed = nn.Embedding(type_vocab_size, units,
                                             dtype=dtype, device=device)
        self.position_embed = new_parameter((max_length, units),
                                            to_dtype(dtype), device,
                                            init_mod.Normal(0.02))
        self.embed_ln = nn.LayerNorm(epsilon=layer_norm_eps,
                                     in_channels=units, device=device)
        self._dropout = dropout
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, layer_norm_eps, dtype, device)
        self.pooler = nn.Dense(units, flatten=False, activation="tanh",
                               in_units=units, dtype=dtype, device=device)

    def forward(self, inputs, token_types=None, valid_length=None):
        T = inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x + self.position_embed[:T].unsqueeze(0))
        x = F.dropout(x, self._dropout, self.training)
        mask = None
        if valid_length is not None:
            # (B, 1, 1, T) key-padding mask over heads and queries
            idx = torch.arange(T, device=inputs.device)
            mask = (idx.unsqueeze(0) < valid_length.reshape(-1, 1)) \
                .to(torch.float32).reshape(-1, 1, 1, T)
        seq = self.encoder(x, mask)
        pooled = self.pooler(seq[:, 0].reshape(-1, self.units))
        return seq, pooled


class BERTForPretraining(HybridBlock):
    """MLM and NSP heads over a :class:`BERTModel`; ``forward`` returns
    ``(mlm_scores (B, T, vocab), nsp_scores (B, 2))``. The MLM decoder
    ties the word-embedding matrix."""

    _tensor_body = True

    def __init__(self, bert: BERTModel, vocab_size=30522, device=None):
        super().__init__()
        device = bert.device if device is None else resolve_device(device)
        self.bert = bert
        units = bert.units
        self.mlm_transform = nn.Dense(units, flatten=False, in_units=units,
                                      device=device)
        self.mlm_ln = nn.LayerNorm(in_channels=units, device=device)
        self.mlm_decoder_bias = new_parameter((vocab_size,), torch.float32,
                                              device, "zeros")
        self.nsp_classifier = nn.Dense(2, in_units=units, device=device)

    def forward(self, inputs, token_types=None, valid_length=None):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = F.leaky_relu(self.mlm_transform(seq), act_type="gelu")
        h = self.mlm_ln(h)
        # the registered matmul op, as the reference's np.matmul: under AMP
        # the scores come out in the AMP dtype
        mlm_scores = F.matmul(h, self.bert.word_embed.weight.t()) + \
            self.mlm_decoder_bias
        return mlm_scores, self.nsp_classifier(pooled)


_SPECS = {
    "base": dict(num_layers=12, units=768, hidden_size=3072, num_heads=12),
    "large": dict(num_layers=24, units=1024, hidden_size=4096,
                  num_heads=16),
}


def bert_base(vocab_size=30522, max_length=512, dropout=0.1,
              dtype="float32", **kwargs):
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, dtype=dtype, **_SPECS["base"], **kwargs)


def bert_large(vocab_size=30522, max_length=512, dropout=0.1,
               dtype="float32", **kwargs):
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, dtype=dtype, **_SPECS["large"],
                     **kwargs)
