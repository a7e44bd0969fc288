"""The three program families of the decode engine, as eager callables.

Counterpart of ``mxnet_tpu/serve/decode/programs.py``. The families and
their ladders are the reference's:

- ``prefill(bucket_batch, bucket_len)``: forward right-padded prompts from
  position 0, argmax each row's last valid logits, scatter the per-layer
  k/v into the pool pages each row's page table maps;
- ``prefill_ext(bucket_batch, bucket_len)``: the radix prefix-cache join —
  forward only the prompt suffix from a page-aligned ``start``, attending
  the resident prefix pages plus its own k/v (only with the prefix cache);
- ``decode_tick_k(num_slots, K)``: K tokens for every slot against the
  paged pool (K > 1 verifies a K-1-token draft).

Where the reference traces and AOT-compiles one XLA executable per bucket,
the port keeps one eager callable per bucket that checks its operands'
shapes and runs the model under ``torch.inference_mode()``; the pools are
updated in place. Ahead-of-time export, warmup manifests and tensor
parallelism come with later slices and raise :class:`MXNetError` here.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import _build
from ...tune import preload as _tune_preload
from ..bucketing import bucket_ladder

__all__ = ["DecodePrograms"]

_LATER = "comes with a later slice of the PyTorch/CUDA port"


class DecodePrograms:
    """The program table of one decode engine, built from a live model."""

    def __init__(self, model, *, num_slots, max_len, prefill_batch=4,
                 max_prompt_len=None, min_prompt_bucket=8, page_tokens=128,
                 kv_pages=None, speculate_k=1, prefix_cache=True, tp=1):
        if model is None:
            raise MXNetError(
                "DecodePrograms needs a model: serving from an export "
                f"{_LATER}")
        if int(tp) != 1:
            raise MXNetError(f"tensor-parallel serving (tp={tp}) {_LATER}")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.prefill_batch = int(prefill_batch)
        max_prompt_len = int(max_prompt_len or self.max_len)
        if max_prompt_len > self.max_len:
            raise MXNetError(
                f"max_prompt_len {max_prompt_len} exceeds cache max_len "
                f"{self.max_len}")
        self.max_prompt_len = max_prompt_len
        # a page larger than the whole cache row would re-grow per-slot
        # reservation past the slot-cache design
        self.page_tokens = min(int(page_tokens), self.max_len)
        if self.page_tokens < 1:
            raise MXNetError(
                f"page_tokens must be >= 1, got {page_tokens}")
        self.pages_per_slot = -(-self.max_len // self.page_tokens)
        self.kv_pages = int(kv_pages or
                            self.num_slots * self.pages_per_slot)
        if self.kv_pages < -(-self.max_prompt_len // self.page_tokens):
            raise MXNetError(
                f"kv_pages {self.kv_pages} cannot hold even one "
                f"max_prompt_len={self.max_prompt_len} prompt at "
                f"page_tokens={self.page_tokens}")
        self.speculate_k = max(1, int(speculate_k))
        if self.speculate_k > self.page_tokens:
            raise MXNetError(
                f"speculate_k {self.speculate_k} exceeds page_tokens "
                f"{self.page_tokens} (a tick must fit in one new page)")
        self.prefix_cache = bool(prefix_cache)
        self.batch_ladder = bucket_ladder(self.prefill_batch)
        self.len_ladder = bucket_ladder(
            max_prompt_len, min_bucket=min(min_prompt_bucket,
                                           max_prompt_len))
        self._model = model
        self.device = model.device
        head_dim = model._units // model._num_heads
        self.cache_shape = (self.kv_pages, model._num_layers,
                            model._num_heads, self.page_tokens, head_dim)
        self.cache_dtype = model._dtype
        self._programs = {}  # ("decode", K) | ("prefill"[_ext], B, T) -> fn

    @property
    def table_width(self):
        return self.pages_per_slot + 1

    # -- the three families ----------------------------------------------
    def _decode(self, tokens, positions, table, kp, vp):
        logits, kp, vp = self._model.forward_decode_paged(
            tokens, positions, table, kp, vp)
        return torch.argmax(logits, dim=-1).to(torch.int32), kp, vp

    def _prefill(self, tokens, valid, table, kp, vp):
        last, kp, vp = self._model.forward_prefill_paged(
            tokens, valid, table, kp, vp)
        return torch.argmax(last, dim=-1).to(torch.int32), kp, vp

    def _prefill_ext(self, tokens, valid, start, table, kp, vp):
        last, kp, vp = self._model.forward_prefill_join(
            tokens, valid, start, table, kp, vp)
        return torch.argmax(last, dim=-1).to(torch.int32), kp, vp

    def ensure(self, kind, batch=None, length=None):
        """The (memoized) callable of one bucket; its operands:
        decode (tokens (S, K), positions (S,), table, kp, vp); prefill
        (tokens (B, T), valid (B,), table, kp, vp); prefill_ext (tokens,
        valid, start (B,), table, kp, vp)."""
        if kind == "decode":
            key = ("decode", self.speculate_k)
            lead = (self.num_slots, self.speculate_k)
        elif kind in ("prefill", "prefill_ext"):
            key = (kind, int(batch), int(length))
            if int(length) not in self.len_ladder or \
                    int(batch) not in self.batch_ladder or \
                    (kind == "prefill_ext" and not self.prefix_cache):
                raise MXNetError(
                    f"no {kind} program for batch {batch}, length bucket "
                    f"{length} (ladders: {self.batch_ladder}, "
                    f"{self.len_ladder}; prefix_cache={self.prefix_cache})")
            lead = (int(batch), int(length))
        else:
            raise MXNetError(f"unknown program family {kind!r}")
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        family = {"decode": self._decode, "prefill": self._prefill,
                  "prefill_ext": self._prefill_ext}[kind]

        def prog(*args):
            if tuple(args[0].shape) != lead:
                raise MXNetError(
                    f"{'|'.join(map(str, key))}: tokens {tuple(args[0].shape)}"
                    f" do not fit the bucket {lead}")
            with torch.inference_mode():
                return family(*args)

        self._programs[key] = prog
        return prog

    def run(self, key, datas):
        """Run one bucket's callable on device operands."""
        return self._programs[key](*datas)

    def warmup(self, k_pool=None, v_pool=None):
        """Build the whole program table (and the CUDA kernels on a GPU).
        Given the engine's pools, also run every bucket once with page
        tables that hold only the sentinel — every pool write drops, so the
        pools are left as they were — so that no request pays a first-call
        cost (library handles, lazily loaded device code). Tuned kernel
        tiles (``MXTPU_TUNE=1``) preload first, so every bucket resolves
        its tiles from the persisted winners — the engine never tunes
        online."""
        _tune_preload()
        if self.device.type == "cuda":
            _build.build()
        keys = [("decode", self.speculate_k)]
        for T in self.len_ladder:
            for B in self.batch_ladder:
                keys.append(("prefill", B, T))
                if self.prefix_cache:
                    keys.append(("prefill_ext", B, T))
        for key in keys:
            if key[0] == "decode":
                self.ensure("decode")
            else:
                self.ensure(key[0], batch=key[1], length=key[2])
            if k_pool is None:
                continue
            rows = self.num_slots if key[0] == "decode" else key[1]
            zeros = torch.zeros(rows, dtype=torch.int32, device=self.device)
            table = torch.full((rows, self.table_width), self.kv_pages,
                               dtype=torch.int32, device=self.device)
            if key[0] == "decode":
                args = [torch.zeros((rows, key[1]), dtype=torch.int32,
                                    device=self.device), zeros]
            else:
                args = [torch.zeros((rows, key[2]), dtype=torch.int32,
                                    device=self.device), zeros + 1]
                if key[0] == "prefill_ext":
                    args.append(zeros)
            self.run(key, args + [table, k_pool, v_pool])

    def manifest_dict(self, *args, **kwargs):
        raise MXNetError(f"decode warmup manifests {_LATER}")

    def export(self, prefix):
        raise MXNetError(f"exporting decode programs {_LATER}")

    @classmethod
    def from_export(cls, prefix_or_manifest):
        raise MXNetError(f"serving decode programs from an export {_LATER}")
