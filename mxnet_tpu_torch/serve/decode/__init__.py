"""Continuous-batching autoregressive decoding over a paged KV pool.

Counterpart of ``mxnet_tpu.serve.decode``: paged KV cache
(:mod:`.cache`), the three program families (:mod:`.programs`), radix
prefix cache (:mod:`.prefix`), speculative verification (:mod:`.spec`) and
the scheduler (:mod:`.engine`).

Quick start::

    eng = DecodeEngine(model, num_slots=8)          # on the GPU
    eng.warmup("gpt.decode.manifest.json")          # capture every bucket
    stream = eng.submit(prompt_ids, max_new_tokens=32)
    for tok in stream:                              # tokens as they land
        ...
"""
from .cache import KVCache, PageAllocator, PagedKVCache, SlotAllocator
from .engine import DecodeEngine, DecodeStream, EngineDeadError, ShedError
from .prefix import RadixPrefixCache
from .programs import DecodePrograms, load_decode_manifest
from .spec import (LastTokenDraft, NgramDraft, accept_longest_prefix,
                   make_draft)

__all__ = ["DecodeEngine", "DecodeStream", "ShedError", "EngineDeadError",
           "KVCache", "SlotAllocator", "PageAllocator", "PagedKVCache",
           "RadixPrefixCache", "DecodePrograms", "load_decode_manifest",
           "NgramDraft", "LastTokenDraft", "make_draft",
           "accept_longest_prefix"]
