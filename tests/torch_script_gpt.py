"""The JAX package's GPT body as a user would write it against the port.

``ScriptDecoderLayer`` and ``ScriptGPT`` are ``DecoderLayer`` (the
``ctx is None`` branch of ``_qkv``, ``_post_attention`` and
``forward_prefill``) and ``GPTModel`` (``__init__``, ``_lm_logits``,
``_pad_mask``, ``_embed``, ``forward``) of
``mxnet_tpu/gluon/model_zoo/gpt.py`` (:72-152, :196-290), copied line for
line. Only the imports change, and the tensor-parallel branches are gone
(each marked where it was). The bodies use ``mx.np``/``mx.npx`` on layer
outputs, ``Parameter.data()`` for the tied head and NDArray methods on
their inputs, so they run the port's reference-style Gluon path. The
parameter names are the reference's and the port's own ``GPTModel``'s.

A helper of the tests and of ``chip_smoke.py``, not a test; it imports
only ``mxnet_tpu_torch``.
"""
from mxnet_tpu_torch import initializer as init_mod
from mxnet_tpu_torch import numpy_extension as npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock

__all__ = ["ScriptDecoderLayer", "ScriptGPT"]


class ScriptDecoderLayer(HybridBlock):
    """Pre-LN causal transformer block (GPT-2 convention)."""

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, layer_norm_eps=1e-5, dtype="float32",
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError("units must be divisible by num_heads")
        self._num_heads = num_heads
        self._dropout = dropout
        self.ln_1 = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn_qkv = nn.Dense(3 * units, flatten=False, dtype=dtype,
                                 weight_initializer=init_mod.Normal(0.02),
                                 in_units=units)
        self.attn_proj = nn.Dense(units, flatten=False, dtype=dtype,
                                  weight_initializer=init_mod.Normal(0.02),
                                  in_units=units)
        self.ln_2 = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn_1 = nn.Dense(hidden_size, flatten=False, dtype=dtype,
                              weight_initializer=init_mod.Normal(0.02),
                              in_units=units)
        self.ffn_2 = nn.Dense(units, flatten=False, dtype=dtype,
                              weight_initializer=init_mod.Normal(0.02),
                              in_units=hidden_size)

    def _qkv(self, x):
        h = self.ln_1(x)
        # (tensor-parallel branch removed: megatron f at the region's entry)
        qkv = self.attn_qkv(h)
        # under tp the local qkv is [Q_r | K_r | V_r] (segments=3 layout),
        # so thirds of the LOCAL width still split q/k/v correctly
        units = qkv.shape[-1] // 3
        q = npx.slice_axis(qkv, axis=-1, begin=0, end=units)
        k = npx.slice_axis(qkv, axis=-1, begin=units, end=2 * units)
        v = npx.slice_axis(qkv, axis=-1, begin=2 * units, end=3 * units)
        return q, k, v

    def _post_attention(self, x, attn):
        from mxnet_tpu_torch import numpy as np  # noqa: F401

        # (tensor-parallel branches removed: row-parallel and serving)
        attn = self.attn_proj(attn)
        if self._dropout:
            attn = npx.dropout(attn, p=self._dropout)
        x = x + attn
        h = self.ln_2(x)
        # (tensor-parallel branch removed: megatron f at the MLP's entry)
        up = npx.leaky_relu(self.ffn_1(h), act_type="gelu")
        # (tensor-parallel branches removed: row-parallel and serving)
        ffn = self.ffn_2(up)
        if self._dropout:
            ffn = npx.dropout(ffn, p=self._dropout)
        return x + ffn

    def forward(self, x, mask=None):
        """``mask``: optional (B, 1, 1, T) key-padding mask (1 = attend).
        Combined with the causal mask on the fused flash path — without it
        pad keys are attended like real tokens."""
        out, _, _ = self.forward_prefill(x, mask)
        return out

    def forward_prefill(self, x, mask=None):
        """Full-sequence forward that also returns this layer's k/v
        (B, T, units) for KV-cache seeding. Runs the exact compute of
        ``forward`` — prefill and the plain forward cannot drift."""
        q, k, v = self._qkv(x)
        attn = npx.multihead_attention(q, k, v, mask=mask,
                                       # (tensor-parallel head count removed)
                                       num_heads=self._num_heads,
                                       causal=True)
        return self._post_attention(x, attn), k, v


class ScriptGPT(HybridBlock):
    """Token+position embeddings → N pre-LN causal blocks → tied LM head."""

    def __init__(self, vocab_size=50257, num_layers=12, units=768,
                 hidden_size=None, num_heads=12, max_length=1024,
                 dropout=0.1, tie_weights=True, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        hidden_size = hidden_size or 4 * units
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._tie = tie_weights
        self._units = units
        self._num_heads = num_heads
        self._num_layers = num_layers
        self._dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, units, dtype=dtype)
        self.pos_embed = nn.Embedding(max_length, units, dtype=dtype)
        self.blocks = nn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(ScriptDecoderLayer(units, hidden_size, num_heads,
                                               dropout, dtype=dtype))
        self.ln_f = nn.LayerNorm(epsilon=1e-5, in_channels=units)
        self._dropout = dropout
        if not tie_weights:
            self.lm_head = nn.Dense(vocab_size, flatten=False,
                                    use_bias=False, dtype=dtype,
                                    in_units=units)

    # (tensor-parallel partition rules removed)

    def _lm_logits(self, x):
        from mxnet_tpu_torch import numpy as np

        if self._tie:
            # weight tying (Press & Wolf): logits = x · E^T
            return np.matmul(x, self.tok_embed.weight.data().T)
        return self.lm_head(x)

    def _pad_mask(self, valid_length, seq_len):
        """(B, 1, 1, T) key-padding mask for right-padded batches: True for
        positions < valid_length. Rides the fused flash path (segment ids)
        when combined with causal attention."""
        from mxnet_tpu_torch import numpy as np

        ar = np.arange(seq_len, dtype="int32").reshape(1, seq_len)
        valid = valid_length.astype("int32").reshape(-1, 1)
        return (ar < valid).reshape(-1, 1, 1, seq_len)

    def _embed(self, tokens, pos):
        x = self.tok_embed(tokens) + self.pos_embed(pos)
        if self._dropout:
            x = npx.dropout(x, p=self._dropout)
        return x

    # -- full-sequence forward ----------------------------------------------
    def forward(self, tokens, valid_length=None):
        """Causal LM forward. ``valid_length`` (B,) marks right-padded rows:
        pad keys (positions >= valid_length) are masked out of attention.
        Without it every position is treated as real — callers padding
        their batches must pass it or pad tokens leak into the context."""
        from mxnet_tpu_torch import numpy as np

        B, T = tokens.shape
        pos = np.arange(T, dtype="int32").reshape(1, T)
        x = self._embed(tokens, pos)
        mask = None if valid_length is None \
            else self._pad_mask(valid_length, T)
        for blk in self.blocks:
            x = blk(x, mask) if mask is not None else blk(x)
        x = self.ln_f(x)
        return self._lm_logits(x)
