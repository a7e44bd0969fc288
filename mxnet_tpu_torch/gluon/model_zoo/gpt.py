"""GPT-style decoder-only causal language model, in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: a pre-LN causal
decoder (GPT-2's architecture) with the same parameter names, the same
full-sequence ``forward``, the slot-cache ``forward_prefill`` /
``forward_decode`` pair, the paged trio the decode engine runs
(``forward_prefill_paged`` / ``forward_prefill_join`` /
``forward_decode_paged``) and ``generate``.

Attention of the full-sequence paths goes through the flash-attention
kernel (right-padded batches through segment ids); LayerNorm through the
fused LayerNorm kernel. The paged join and decode paths pass masks with
Tq != Tk and so take the dense masked attention branch, as in the
reference.

Training runs through ``forward(tokens, valid_length)`` under
``autograd.record()``: the backward of the flash attention runs the two
backward kernels (right-padded rows again through segment ids), and the
tied LM head's embedding takes the gradients of both its uses. Dropout is
active inside ``record()`` (or after ``train()``), drawing from the device
generator of :mod:`mxnet_tpu_torch.random`, and the identity elsewhere, so
the serving paths never drop units.

Paged pools are written IN PLACE by index scatter, where the reference
scatters through one-hot einsums and returns new pools: this saves a copy
of the pool per program run. Every shape of the paged paths follows from
the operands' shapes alone, and nothing there waits for the device, so a
CUDA graph can hold them (the decode engine captures each bucket). A write
the reference drops (a column holding the sentinel page id ``num_pages``,
whose one-hot row is zero; a chunk past ``valid_length``; a position past
the page view) is aimed at a clamped cell that holds what every other
write to that cell holds: the live write's value where one lands there,
else the cell's own content (:meth:`GPTModel._owners`). Duplicate indices
of one scatter then carry one value, so their order does not matter, and
the pools end equal to the reference's. Reads clip the sentinel to page
``num_pages - 1`` as ``take(mode="clip")`` does.

The prefill paths gather each row's last valid hidden state before
``ln_f`` and the LM head (the reference computes the (B, T, V) logits and
then picks the row by a one-hot contraction, gpt.py:329-332): the same
values within fp32 rounding, without the (B, T, V) temporary.

The tensor-parallel hooks of the reference (``_local_heads``,
``gpt_tp_rules``) are not ported yet.
"""
from __future__ import annotations

import numpy as onp
import torch

from ... import initializer as init_mod
from ...base import MXNetError, to_dtype
from ...context import resolve_device
from ...ops import nn as F
from .. import nn
from ..block import HybridBlock

__all__ = ["GPTModel", "DecoderLayer", "gpt2_small", "gpt2_medium",
           "gpt_tiny"]


class DecoderLayer(HybridBlock):
    """Pre-LN causal transformer block (GPT-2 convention)."""

    _tensor_body = True

    def __init__(self, units=768, hidden_size=3072, num_heads=12,
                 dropout=0.1, layer_norm_eps=1e-5, dtype="float32",
                 device=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError("units must be divisible by num_heads")
        device = resolve_device(device)
        self._num_heads = num_heads
        self._dropout = dropout
        w_init = init_mod.Normal(0.02)
        self.ln_1 = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 device=device)
        self.attn_qkv = nn.Dense(3 * units, flatten=False, dtype=dtype,
                                 weight_initializer=w_init, in_units=units,
                                 device=device)
        self.attn_proj = nn.Dense(units, flatten=False, dtype=dtype,
                                  weight_initializer=w_init, in_units=units,
                                  device=device)
        self.ln_2 = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                 device=device)
        self.ffn_1 = nn.Dense(hidden_size, flatten=False, dtype=dtype,
                              weight_initializer=w_init, in_units=units,
                              device=device)
        self.ffn_2 = nn.Dense(units, flatten=False, dtype=dtype,
                              weight_initializer=w_init,
                              in_units=hidden_size, device=device)

    def _qkv(self, x):
        qkv = self.attn_qkv(self.ln_1(x))
        return qkv.chunk(3, dim=-1)

    def _post_attention(self, x, attn):
        attn = F.dropout(self.attn_proj(attn), self._dropout, self.training)
        x = x + attn
        up = F.leaky_relu(self.ffn_1(self.ln_2(x)), act_type="gelu")
        ffn = F.dropout(self.ffn_2(up), self._dropout, self.training)
        return x + ffn

    def forward(self, x, mask=None):
        """``mask``: optional (B, 1, 1, T) key-padding mask (1 = attend)."""
        out, _, _ = self.forward_prefill(x, mask)
        return out

    def forward_prefill(self, x, mask=None):
        """Full-sequence forward that also returns this layer's k/v
        (B, T, units)."""
        q, k, v = self._qkv(x)
        attn = F.multihead_attention(q, k, v, mask=mask,
                                     num_heads=self._num_heads, causal=True)
        return self._post_attention(x, attn), k, v

    def forward_decode(self, x, k_cache, v_cache, write_mask, kv_mask):
        """One-token step against this layer's flat (B, max_len, units)
        cache; returns (out, k_cache', v_cache')."""
        q, k, v = self._qkv(x)
        k_cache = torch.where(write_mask, k, k_cache)
        v_cache = torch.where(write_mask, v, v_cache)
        attn = F.multihead_attention(q, k_cache, v_cache, mask=kv_mask,
                                     num_heads=self._num_heads, causal=False)
        return self._post_attention(x, attn), k_cache, v_cache


class GPTModel(HybridBlock):
    """Token+position embeddings -> N pre-LN causal blocks -> tied LM head.

    ``device``: where the parameters live; ``None`` means the GPU (and
    raises without one) — pass ``device="cpu"`` to run on the host.
    """

    _tensor_body = True

    def __init__(self, vocab_size=50257, num_layers=12, units=768,
                 hidden_size=None, num_heads=12, max_length=1024,
                 dropout=0.1, tie_weights=True, dtype="float32", device=None):
        super().__init__()
        device = resolve_device(device)
        hidden_size = hidden_size or 4 * units
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._tie = tie_weights
        self._units = units
        self._num_heads = num_heads
        self._num_layers = num_layers
        self._dtype = to_dtype(dtype)
        self._dropout = dropout
        self.tok_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                      device=device)
        self.pos_embed = nn.Embedding(max_length, units, dtype=dtype,
                                      device=device)
        self.blocks = nn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(DecoderLayer(units, hidden_size, num_heads,
                                         dropout, dtype=dtype, device=device))
        self.ln_f = nn.LayerNorm(epsilon=1e-5, in_channels=units,
                                 device=device)
        if not tie_weights:
            self.lm_head = nn.Dense(vocab_size, flatten=False,
                                    use_bias=False, dtype=dtype,
                                    in_units=units, device=device)

    # -- shared pieces ------------------------------------------------------
    def _tensor(self, x, dtype=torch.int32):
        """Host data (list / numpy / tensor) as a tensor on this model's
        device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(onp.asarray(x), dtype=dtype,
                               device=self.device)

    def _lm_logits(self, x):
        if self._tie:
            # the registered matmul op, as the reference's np.matmul: under
            # AMP the logits come out in the AMP dtype
            return F.matmul(x, self.tok_embed.weight.t())
        return self.lm_head(x)

    def _pad_mask(self, valid_length, seq_len):
        """(B, 1, 1, T) key-padding mask: True for positions < valid."""
        ar = torch.arange(seq_len, dtype=torch.int32,
                          device=valid_length.device).reshape(1, seq_len)
        valid = valid_length.to(torch.int32).reshape(-1, 1)
        return (ar < valid).reshape(-1, 1, 1, seq_len)

    def _split_heads(self, x):
        """(B, T, units) -> (B, heads, T, head_dim)."""
        B, T, U = x.shape
        d = self._units // self._num_heads
        return x.reshape(B, T, U // d, d).transpose(1, 2)

    def _merge_heads(self, x):
        """(B, heads, T, head_dim) -> (B, T, units)."""
        B, H, T, D = x.shape
        return x.transpose(1, 2).reshape(B, T, H * D)

    def _embed(self, tokens, pos):
        x = self.tok_embed(tokens) + self.pos_embed(pos)
        return F.dropout(x, self._dropout, self.training)

    def _last_valid(self, x, valid_length):
        """LM logits (B, V) at each row's last valid position of the final
        hidden states ``x`` (B, T, U): the row is gathered first, then
        ``ln_f`` and the head run on B rows (the reference picks it from the
        (B, T, V) logits by a one-hot contraction, gpt.py:329-332).
        ``valid_length`` >= 1."""
        rows = torch.arange(x.shape[0], device=x.device)
        last = (valid_length.long() - 1).clamp_min(0)
        return self._lm_logits(self.ln_f(x[rows, last]))

    @staticmethod
    def _owners(cell, live, n_cells):
        """For writes aimed at ``cell`` (n,) int64 in [0, n_cells): the
        index of the live write that lands on each write's cell, or -1 where
        none does. A write that is not ``live`` writes the owner's value
        (or, without one, the cell's own content), so every write to one
        cell carries one value and a scatter's order cannot matter."""
        owner = torch.full((n_cells + 1,), -1, dtype=torch.long,
                           device=cell.device)
        owner.scatter_(0, torch.where(live, cell, n_cells),
                       torch.arange(cell.numel(), device=cell.device))
        return owner[cell]

    # -- full-sequence forward ----------------------------------------------
    def forward(self, tokens, valid_length=None):
        """Causal LM forward; ``valid_length`` (B,) masks right padding."""
        B, T = tokens.shape
        pos = torch.arange(T, dtype=torch.int32,
                           device=tokens.device).reshape(1, T)
        x = self._embed(tokens, pos)
        mask = None if valid_length is None \
            else self._pad_mask(valid_length, T)
        for blk in self.blocks:
            x = blk(x, mask)
        return self._lm_logits(self.ln_f(x))

    # -- incremental decode (slot KV cache) ----------------------------------
    def init_cache(self, batch, max_len):
        """KV cache pair, each [batch, layers, heads, max_len, head_dim]."""
        if max_len > self.max_length:
            raise MXNetError(
                f"cache max_len {max_len} exceeds the position table "
                f"max_length={self.max_length}")
        d = self._units // self._num_heads
        shape = (batch, self._num_layers, self._num_heads, max_len, d)
        return (torch.zeros(shape, dtype=self._dtype, device=self.device),
                torch.zeros(shape, dtype=self._dtype, device=self.device))

    def forward_prefill(self, tokens, valid_length):
        """Whole right-padded prompts: returns (last_logits (B, V),
        k (B, layers, heads, T, head_dim), v)."""
        B, T = tokens.shape
        pos = torch.arange(T, dtype=torch.int32,
                           device=tokens.device).reshape(1, T)
        x = self._embed(tokens, pos)
        mask = self._pad_mask(valid_length, T)
        ks, vs = [], []
        for blk in self.blocks:
            x, k, v = blk.forward_prefill(x, mask)
            ks.append(self._split_heads(k))
            vs.append(self._split_heads(v))
        last = self._last_valid(x, valid_length)          # (B, V)
        return last, torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    def forward_decode(self, tokens, positions, k_cache, v_cache):
        """One decode tick, one new token per cache row: returns
        (logits (S, V), k_cache', v_cache')."""
        L = k_cache.shape[3]
        pos2 = positions.to(torch.int32).reshape(-1, 1)
        x = self._embed(tokens.reshape(-1, 1),
                        pos2.clamp_max(self.max_length - 1))
        ar = torch.arange(L, dtype=torch.int32,
                          device=tokens.device).reshape(1, L)
        write_mask = (ar == pos2).reshape(-1, L, 1)
        kv_mask = (ar <= pos2).reshape(-1, 1, 1, L)
        nk, nv = [], []
        for i, blk in enumerate(self.blocks):
            kc = self._merge_heads(k_cache[:, i])
            vc = self._merge_heads(v_cache[:, i])
            x, kc, vc = blk.forward_decode(x, kc, vc, write_mask, kv_mask)
            nk.append(self._split_heads(kc))
            nv.append(self._split_heads(vc))
        logits = self._lm_logits(self.ln_f(x))            # (S, 1, V)
        return (logits.squeeze(1), torch.stack(nk, dim=1),
                torch.stack(nv, dim=1))

    # -- paged incremental decode ---------------------------------------------
    #
    # Pool shape [num_pages, layers, heads, page_tokens, head_dim]; a slot's
    # cache is an int32 page-table row of width W+1 mapping logical page ->
    # pool page id, with the sentinel ``num_pages`` on unmapped columns
    # (column W is always the sentinel).
    def init_paged_cache(self, num_pages, page_tokens):
        """Paged KV pool pair, each [num_pages, layers, heads, page_tokens,
        head_dim]."""
        d = self._units // self._num_heads
        shape = (int(num_pages), self._num_layers, self._num_heads,
                 int(page_tokens), d)
        return (torch.zeros(shape, dtype=self._dtype, device=self.device),
                torch.zeros(shape, dtype=self._dtype, device=self.device))

    @staticmethod
    def _gather_page_view(pool_layer, flat_ids, W):
        """Page-table rows (W columns each, flattened in ``flat_ids``) of one
        layer's [NP, H, P, D] pool as a contiguous (rows, W*P, H*D) view;
        the sentinel id clips to the last page."""
        NP_, H, P, D = pool_layer.shape
        view = pool_layer[flat_ids.long().clamp(0, NP_ - 1)]
        view = view.reshape(-1, W, H, P, D).permute(0, 1, 3, 2, 4)
        return view.reshape(-1, W * P, H * D)

    @classmethod
    def _scatter_pages(cls, k, v, valid_length, start, page_table, k_pool,
                       v_pool):
        """Write per-layer prompt k/v (B, layers, heads, T, head_dim) into
        the pools, in place, at the pages ``page_table`` maps for logical
        pages start//P + j. Chunks at or past ``valid_length`` and chunks
        whose column holds the sentinel are dropped (``_owners``)."""
        NP_, L, H, P, D = k_pool.shape
        T = k.shape[3]
        W = page_table.shape[1] - 1
        J = -(-T // P)
        pad = J * P - T
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        # (B, L, H, J*P, D) -> (B, L, H, J, P, D): chunk (b, j) is [b, :, :, j]
        k = k.reshape(-1, L, H, J, P, D)
        v = v.reshape(-1, L, H, J, P, D)
        j_idx = torch.arange(J, device=k.device).reshape(1, J)
        base = (start.long() // P).reshape(-1, 1) if start is not None \
            else torch.zeros_like(valid_length, dtype=torch.long
                                  ).reshape(-1, 1)
        col = (base + j_idx).clamp_max(W)
        page_id = torch.gather(page_table.long(), 1, col)      # (B, J)
        live = (j_idx * P < valid_length.long().reshape(-1, 1)) & \
            (page_id < NP_)
        cell = page_id.clamp_max(NP_ - 1).reshape(-1)
        w = cls._owners(cell, live.reshape(-1), NP_)
        wb, wj = w.clamp_min(0) // J, w.clamp_min(0) % J
        keep = (w >= 0).reshape(-1, 1, 1, 1, 1)
        k_pool[cell] = torch.where(keep, k[wb, :, :, wj], k_pool[cell])
        v_pool[cell] = torch.where(keep, v[wb, :, :, wj], v_pool[cell])

    def forward_prefill_paged(self, tokens, valid_length, page_table,
                              k_pool, v_pool):
        """Whole-prompt prefill into a paged pool (prompts from position 0):
        the exact compute of ``forward_prefill``, then a page-chunk scatter.
        Returns (last_logits (B, V), k_pool, v_pool) — the pools updated in
        place."""
        last, k, v = self.forward_prefill(tokens, valid_length)
        self._scatter_pages(k, v, valid_length, None, page_table, k_pool,
                            v_pool)
        return last, k_pool, v_pool

    @classmethod
    def _own_rows(cls, pos, WP):
        """Routing of this run's own k/v rows (``pos`` (B, T) absolute
        positions) into a flattened (B * WP) page view: (cell, owner) with
        positions past the view dropped (``_owners``). Computed once per
        program run and shared by every layer."""
        B, T = pos.shape
        rows = torch.arange(B, device=pos.device).reshape(-1, 1) * WP
        cell = (rows + pos.clamp_max(WP - 1)).reshape(-1)
        return cell, cls._owners(cell, (pos < WP).reshape(-1), B * WP)

    def _page_view(self, pool_layer, flat_ids, W, rows, x):
        """One layer's gathered page view with this run's own k or v ``x``
        (B, T, U) written over it at ``rows`` (the reference's one-hot
        contraction, gpt.py:503-506). The gather is a fresh copy, so the
        write goes in place."""
        cell, owner = rows
        view = self._gather_page_view(pool_layer, flat_ids, W)
        flat = view.view(-1, view.shape[-1])
        own = x.reshape(-1, x.shape[-1])
        flat[cell] = torch.where((owner >= 0).reshape(-1, 1),
                                 own[owner.clamp_min(0)], flat[cell])
        return view

    def forward_prefill_join(self, tokens, valid_length, start, page_table,
                             k_pool, v_pool):
        """Suffix prefill joining a cached prefix at page-aligned offset
        ``start`` (B,): each query attends the gathered page view plus the
        suffix's own k/v, masked to absolute positions <= its own; the
        suffix k/v then scatters into pages start//P + j.
        Returns (last_logits (B, V), k_pool, v_pool), pools updated in
        place."""
        NP_, L, H, P, D = k_pool.shape
        B, T = tokens.shape
        W = page_table.shape[1] - 1
        WP = W * P
        pos = start.long().reshape(-1, 1) + \
            torch.arange(T, device=tokens.device).reshape(1, T)
        x = self._embed(tokens, pos.clamp_max(self.max_length - 1))
        ar = torch.arange(WP, device=tokens.device).reshape(1, 1, WP)
        mask = (ar <= pos.reshape(-1, T, 1)).reshape(-1, 1, T, WP)
        flat_ids = page_table[:, :W].reshape(-1)
        rows = self._own_rows(pos, WP)
        ks, vs = [], []
        for i, blk in enumerate(self.blocks):
            q, k, v = blk._qkv(x)
            ks.append(self._split_heads(k))
            vs.append(self._split_heads(v))
            viewk = self._page_view(k_pool[:, i], flat_ids, W, rows, k)
            viewv = self._page_view(v_pool[:, i], flat_ids, W, rows, v)
            attn = F.multihead_attention(q, viewk, viewv, mask=mask,
                                         num_heads=self._num_heads,
                                         causal=False)
            x = blk._post_attention(x, attn)
        last = self._last_valid(x, valid_length)                 # (B, V)
        self._scatter_pages(torch.stack(ks, dim=1), torch.stack(vs, dim=1),
                            valid_length, start, page_table, k_pool, v_pool)
        return last, k_pool, v_pool

    def forward_decode_paged(self, tokens, positions, page_table, k_pool,
                             v_pool):
        """One multi-token decode tick against the paged pool.

        tokens (S, K): column 0 each row's last committed token, columns
        1..K-1 a draft; positions (S,): column 0's write position.
        Returns (logits (S, K, V), k_pool, v_pool), pools updated in place;
        logits[:, i] scores the token after tokens[:, i].
        """
        NP_, L, H, P, D = k_pool.shape
        S, K = tokens.shape
        W = page_table.shape[1] - 1
        WP = W * P
        q_pos = positions.long().reshape(-1, 1) + \
            torch.arange(K, device=tokens.device).reshape(1, K)  # (S, K)
        x = self._embed(tokens, q_pos.clamp_max(self.max_length - 1))
        ar = torch.arange(WP, device=tokens.device).reshape(1, 1, WP)
        mask = (ar <= q_pos.reshape(S, K, 1)).reshape(S, 1, K, WP)
        flat_ids = page_table[:, :W].reshape(-1)
        # pool write routing, shared by every layer: (page, offset) cells;
        # the sentinel page drops the write
        page_id = torch.gather(page_table.long(), 1,
                               (q_pos // P).clamp_max(W)).reshape(-1)
        cell_page = page_id.clamp_max(NP_ - 1)
        cell_off = (q_pos % P).reshape(-1)
        owner = self._owners(cell_page * P + cell_off, page_id < NP_,
                             NP_ * P)
        keep = (owner >= 0).reshape(-1, 1, 1, 1)
        owner = owner.clamp_min(0)
        rows = self._own_rows(q_pos, WP)
        nk, nv = [], []
        for i, blk in enumerate(self.blocks):
            q, k, v = blk._qkv(x)
            nk.append(k.reshape(S, K, H, D))
            nv.append(v.reshape(S, K, H, D))
            viewk = self._page_view(k_pool[:, i], flat_ids, W, rows, k)
            viewv = self._page_view(v_pool[:, i], flat_ids, W, rows, v)
            attn = F.multihead_attention(q, viewk, viewv, mask=mask,
                                         num_heads=self._num_heads,
                                         causal=False)
            x = blk._post_attention(x, attn)
        logits = self._lm_logits(self.ln_f(x))                    # (S, K, V)
        knew = torch.stack(nk, dim=2).reshape(S * K, L, H, D)[owner]
        vnew = torch.stack(nv, dim=2).reshape(S * K, L, H, D)[owner]
        k_pool[cell_page, :, :, cell_off] = torch.where(
            keep, knew, k_pool[cell_page, :, :, cell_off])
        v_pool[cell_page, :, :, cell_off] = torch.where(
            keep, vnew, v_pool[cell_page, :, :, cell_off])
        return logits, k_pool, v_pool

    # -- generation ----------------------------------------------------------
    def _sample(self, logits, temperature, generator=None):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return int(torch.multinomial(probs.cpu(), 1,
                                         generator=generator))
        return int(torch.argmax(logits))

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens=20, temperature=0.0,
                 window=None, use_cache=None, generator=None):
        """Greedy / temperature sampling (reference gpt.py:596).

        ``use_cache=None`` takes the incremental KV-cache path whenever the
        whole sequence fits ``max_length``; ``use_cache=False`` re-runs a
        fixed-width, right-padded, masked window per token (default width
        ``min(max_length, 64)``). ``generator`` draws the samples when
        ``temperature > 0``.
        """
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.cpu().numpy()
        toks = [int(t) for t in onp.asarray(prompt).ravel()]
        if max_new_tokens < 1:
            return toks
        total = len(toks) + max_new_tokens
        if use_cache is None:
            use_cache = total <= self.max_length
        if use_cache:
            if total > self.max_length:
                raise MXNetError(
                    f"use_cache generation needs prompt+new <= max_length="
                    f"{self.max_length}, got {total} — pass "
                    "use_cache=False for the rolling-window fallback")
            return self._generate_cached(toks, max_new_tokens, temperature,
                                         generator)
        window = window or min(self.max_length, 64)
        for _ in range(max_new_tokens):
            ctx_toks = toks[-window:]
            L = len(ctx_toks)
            inp = onp.zeros((1, window), dtype="int32")
            inp[0, :L] = ctx_toks
            logits = self(self._tensor(inp), self._tensor([L]))[0, L - 1]
            toks.append(self._sample(logits, temperature, generator))
        return toks

    def _generate_cached(self, toks, max_new_tokens, temperature,
                         generator):
        T0 = len(toks)
        total = T0 + max_new_tokens
        last, k, v = self.forward_prefill(self._tensor([toks]),
                                          self._tensor([T0]))
        pad = total - T0
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        toks.append(self._sample(last[0], temperature, generator))
        for i in range(1, max_new_tokens):
            logits, k, v = self.forward_decode(
                self._tensor([toks[-1]]), self._tensor([T0 + i - 1]), k, v)
            toks.append(self._sample(logits[0], temperature, generator))
        return toks


def gpt_tiny(vocab_size=1000, **kwargs):
    """Test/edge configuration."""
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("units", 64)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("max_length", 128)
    return GPTModel(vocab_size=vocab_size, **kwargs)


def gpt2_small(vocab_size=50257, **kwargs):
    return GPTModel(vocab_size=vocab_size, num_layers=12, units=768,
                    num_heads=12, **kwargs)


def gpt2_medium(vocab_size=50257, **kwargs):
    return GPTModel(vocab_size=vocab_size, num_layers=24, units=1024,
                    num_heads=16, **kwargs)
