"""The three program families of the decode engine, one CUDA graph a bucket.

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
the port captures one ``torch.cuda.CUDAGraph`` per bucket (43 at GPT-2
small's serving configuration: 7 length x 3 batch buckets of each prefill
family, and the tick):

- a program owns its static operands: one flat int32 buffer on the device
  holds its tokens, its positions (tick) or valid lengths, its starts
  (join) and its page table, and one pinned host buffer stages them, so a
  run's operands cross in one non-blocking copy;
- given the engine's pools, :meth:`DecodePrograms.ensure` runs the family
  body once (the warm call: every page table holds only the sentinel, so
  every pool write is dropped), then captures the body into a graph that
  reads the static operands and writes the pools in place;
- :meth:`DecodePrograms.run` copies the operands in, replays, copies the
  argmax tokens to pinned host memory and waits for them, so no output
  outlives its run. A program run before its capture runs the body as its
  warm call, then captures;
- every graph allocates from one shared memory pool
  (``torch.cuda.graph_pool_handle()``): a later capture may reuse an
  earlier capture's freed temporaries, which is sound because the programs
  replay one at a time on one stream and each run's tokens are copied out
  before the next replay;
- a pool found at another address captures anew; ``_captures`` counts the
  programs made ready (captures on the card, programs built on the CPU),
  the analog of the reference's ``jit.compiles``;
- the kernels' launch counters move at capture only: each program keeps
  ``captured_launches`` and a replay count (:meth:`graph_stats`);
- a failed capture or replay raises :class:`MXNetError`; nothing falls back
  to eager execution. Tuned tiles resolve while capturing and stay frozen
  in the graph (``warmup`` preloads the tuning cache first).

On the CPU the same body runs eagerly each run, from the same static
operands. Warmup manifests (``manifest_dict``, :func:`load_decode_manifest`)
record the reference's geometry and program signatures. ``export`` and
``from_export`` round-trip Symbol JSON, which needs the graph layer, and
raise :class:`MXNetError`; so does tensor parallelism.
"""
from __future__ import annotations

import json
import time

import numpy as onp
import torch

from ... import cached_op as _cached_op
from ...base import MXNetError
from ...context import env_signature
from ...ops import _build
from ...tune import preload as _tune_preload
from ..bucketing import bucket_ladder

__all__ = ["DecodePrograms", "load_decode_manifest"]

MANIFEST_VERSION = 2
_GRAPH_LAYER = ("comes with a later slice of the PyTorch/CUDA port: it needs "
                "the graph layer (Symbol JSON, cached ops)")
_SHORT = {"float32": "f32", "float64": "f64", "float16": "f16",
          "bfloat16": "bf16", "int32": "i32", "int64": "i64", "int8": "i8",
          "uint8": "u8", "bool": "b1"}


def _check_manifest(m, where):
    """``m`` when it is a decode manifest of this version, else raise."""
    if not isinstance(m, dict) or m.get("kind") != "decode_engine" or \
            m.get("version") != MANIFEST_VERSION:
        got = m if isinstance(m, dict) else {}
        raise MXNetError(
            f"unsupported decode manifest in {where}: version="
            f"{got.get('version')!r} kind={got.get('kind')!r} (this build "
            f"reads version {MANIFEST_VERSION}; pre-paging manifests "
            "must be re-exported)")
    return m


def load_decode_manifest(path):
    with open(path) as fh:
        return _check_manifest(json.load(fh), path)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _signature(shapes_dtypes):
    """The reference's compact ``"i32[8,1],f32[64,12,...]"`` signature
    (``telemetry.watchdog.format_signature``) of (shape, dtype) pairs."""
    parts = []
    for shape, dtype in shapes_dtypes:
        name = _dtype_name(dtype)
        parts.append(f"{_SHORT.get(name, name)}[{','.join(map(str, shape))}]")
    return ",".join(parts)


class _Program:
    """One bucket: its static operands, the family body and, on the card,
    its graph."""

    def __init__(self, progs, key):
        self.progs = progs
        self.key = key
        self.kind = key[0]
        dev = progs.device
        if self.kind == "decode":
            rows, lead = progs.num_slots, (progs.num_slots, key[1])
        else:
            rows, lead = key[1], (key[1], key[2])
        shapes = [lead, (rows,)]
        if self.kind == "prefill_ext":
            shapes.append((rows,))
        shapes.append((rows, progs.table_width))
        sizes = [int(onp.prod(s)) for s in shapes]
        on_card = dev.type == "cuda"
        self.flat = torch.zeros(sum(sizes), dtype=torch.int32, device=dev)
        self.stage = torch.zeros(sum(sizes), dtype=torch.int32,
                                 pin_memory=on_card) if on_card else None
        self.inputs, self.staged = [], []
        off = 0
        for shape, n in zip(shapes, sizes):
            self.inputs.append(self.flat[off:off + n].view(shape))
            if on_card:
                self.staged.append(self.stage[off:off + n].view(shape))
            off += n
        # the argmax tokens: (S, K) for the tick, (B,) for a prefill
        self.host_out = torch.zeros(lead if self.kind == "decode" else rows,
                                    dtype=torch.int32, pin_memory=on_card)
        self.signature = _signature(
            [(s, torch.int32) for s in shapes] +
            [(progs.cache_shape, progs.cache_dtype)] * 2)
        self.graph = None
        self.out = None          # the graph's token output (in the pool)
        self.pools = None        # pool addresses the graph writes
        self.captured_launches = None
        self.replays = 0

    def safe(self):
        """Operands under which the body writes nothing: zero tokens, valid
        lengths 1, page tables of the sentinel alone."""
        self.flat.zero_()
        if self.kind != "decode":
            self.inputs[1].fill_(1)
        self.inputs[-1].fill_(self.progs.kv_pages)

    def load(self, datas):
        if len(datas) != len(self.inputs):
            raise MXNetError(
                f"{self.progs._site(self.key)}: {len(datas)} operands, "
                f"expected {len(self.inputs)} and the two pools")
        ts = [d if isinstance(d, torch.Tensor)
              else torch.from_numpy(onp.ascontiguousarray(d)) for d in datas]
        for view, t in zip(self.inputs, ts):
            if tuple(t.shape) != tuple(view.shape):
                raise MXNetError(
                    f"{self.progs._site(self.key)}: operand "
                    f"{tuple(t.shape)} does not fit the bucket's "
                    f"{tuple(view.shape)}")
        if self.stage is not None and all(t.device.type == "cpu"
                                          for t in ts):
            for sv, t in zip(self.staged, ts):
                sv.copy_(t)
            self.flat.copy_(self.stage, non_blocking=True)
        else:
            for view, t in zip(self.inputs, ts):
                view.copy_(t)

    def body(self, kp, vp):
        """The family's forward and argmax on the static operands; the
        pools are written in place. The family is looked up per call.
        Hybridized blocks of the model run inline: the program is the
        graph."""
        family = getattr(self.progs, "_" + self.kind)
        with _cached_op.inlined():
            return family(*self.inputs, kp, vp)[0]

    def current(self, kp, vp):
        return self.graph is not None and \
            self.pools == (kp.data_ptr(), vp.data_ptr())

    def capture(self, kp, vp):
        """The warm call, then the capture (``cached_op.GraphPool``);
        returns the warm call's tokens."""
        progs = self.progs
        out, self.graph, self.out, self.captured_launches, _, _ = \
            progs._gpool.capture(lambda: self.body(kp, vp),
                                 progs._site(self.key))
        self.pools = (kp.data_ptr(), vp.data_ptr())
        progs._captures += 1
        return out

    def replay(self):
        _cached_op.GraphPool.replay(self.graph, self.progs._site(self.key))
        self.replays += 1
        return self.out

    def run(self, kp, vp):
        """Tokens of one run as a host tensor, read after the device is
        done."""
        on_card = self.progs.device.type == "cuda"
        if not (on_card and self.progs._graphs):
            out = self.body(kp, vp)
        elif self.current(kp, vp):
            out = self.replay()
        else:
            out = self.capture(kp, vp)
        self.host_out.copy_(out, non_blocking=on_card)
        if on_card:
            torch.cuda.current_stream(self.progs.device).synchronize()
        return self.host_out.clone()


class DecodePrograms:
    """The program table of one decode engine, built from a live model."""

    def __init__(self, model, *, num_slots, max_len, prefill_batch=4,
                 max_prompt_len=None, min_prompt_bucket=8, page_tokens=128,
                 kv_pages=None, speculate_k=1, prefix_cache=True, tp=1):
        if model is None:
            raise MXNetError(f"DecodePrograms needs a model: serving from an "
                             f"export {_GRAPH_LAYER}")
        if int(tp) != 1:
            raise MXNetError(
                f"tensor-parallel serving (tp={tp}) comes with the "
                "parallelism slice of the PyTorch/CUDA port")
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
        self.tp = 1
        self.batch_ladder = bucket_ladder(self.prefill_batch)
        self.len_ladder = bucket_ladder(
            max_prompt_len, min_bucket=min(min_prompt_bucket,
                                           max_prompt_len))
        self._model = model
        self.device = model.device
        head_dim = model._units // model._num_heads
        self.cache_shape = (self.kv_pages, model._num_layers,
                            model._num_heads, self.page_tokens, head_dim)
        self.cache_dtype = _dtype_name(model._dtype)
        self._programs = {}    # ("decode", K) | ("prefill"[_ext], B, T)
        self._signatures = {}  # "decode|K" | "prefill|B|T" -> signature
        self._captures = 0     # programs made ready (graphs captured)
        # the graphs' shared side stream and memory pool
        self._gpool = _cached_op.GraphPool(self.device)
        self._graphs = True    # False: run the bodies eagerly on the card

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

    @staticmethod
    def _site(key):
        if key[0] == "decode":
            return f"serve.decode_tick_k{key[1]}"
        if key[0] == "prefill_ext":
            return f"serve.prefill_ext_b{key[1]}_t{key[2]}"
        return f"serve.prefill_b{key[1]}_t{key[2]}"

    def _key(self, kind, batch, length):
        if kind == "decode":
            return ("decode", self.speculate_k)
        if kind not in ("prefill", "prefill_ext"):
            raise MXNetError(f"unknown program family {kind!r}")
        if int(length) not in self.len_ladder or \
                int(batch) not in self.batch_ladder or \
                (kind == "prefill_ext" and not self.prefix_cache):
            raise MXNetError(
                f"no {kind} program for batch {batch}, length bucket "
                f"{length} (ladders: {self.batch_ladder}, "
                f"{self.len_ladder}; prefix_cache={self.prefix_cache})")
        return (kind, int(batch), int(length))

    def ensure(self, kind, batch=None, length=None, pools=None):
        """The (memoized) program of one bucket; its operands: decode
        (tokens (S, K), positions (S,), table), prefill (tokens (B, T),
        valid (B,), table), prefill_ext (tokens, valid, start (B,), table),
        each followed by the pools in :meth:`run`. Given the engine's
        ``pools`` (k, v) on the card, also captures it (a warm call and the
        capture, writing nothing to the pools) unless its graph already
        writes those pools."""
        key = self._key(kind, batch, length)
        with torch.inference_mode():
            prog = self._programs.get(key)
            if prog is None:
                prog = _Program(self, key)
                prog.safe()
                self._programs[key] = prog
                self._signatures["|".join(map(str, key))] = prog.signature
                if self.device.type != "cuda" or not self._graphs:
                    self._captures += 1
            if pools is not None and self.device.type == "cuda" and \
                    self._graphs and not prog.current(*pools):
                prog.safe()
                prog.capture(*pools)
        return prog

    def run(self, key, datas):
        """Run one bucket: ``datas`` are its operands (host arrays or
        tensors) and the two pools. Returns (tokens on the host, k pool,
        v pool); the pools are written in place."""
        prog = self._programs.get(key)
        if prog is None:
            raise MXNetError(
                f"{self._site(key)} is not built: call ensure() first")
        *data, kp, vp = datas
        with torch.inference_mode():
            prog.load(data)
            return prog.run(kp, vp), kp, vp

    def keys(self):
        """Every bucket of the table, in warmup order."""
        keys = [("decode", self.speculate_k)]
        for T in self.len_ladder:
            for B in self.batch_ladder:
                keys.append(("prefill", B, T))
                if self.prefix_cache:
                    keys.append(("prefill_ext", B, T))
        return keys

    def warmup(self, k_pool=None, v_pool=None):
        """Build the whole program table (and the CUDA kernels on a GPU).
        Given the engine's pools, also capture every bucket on the card and
        replay it once, or run it once on the CPU, with page tables that
        hold only the sentinel — every pool write drops, so the pools are
        left as they were — so that no request pays a first-call cost.
        Tuned kernel tiles (``MXTPU_TUNE=1``) preload first, so every
        capture resolves its tiles from the persisted winners — the engine
        never tunes online."""
        _tune_preload()
        if self.device.type == "cuda":
            _build.build()
        pools = None if k_pool is None else (k_pool, v_pool)
        for key in self.keys():
            prog = self.ensure(key[0], *key[1:], pools=pools)
            if pools is None:
                continue
            with torch.inference_mode():
                prog.safe()
                if self.device.type == "cuda" and self._graphs:
                    prog.replay()
                    torch.cuda.current_stream(self.device).synchronize()
                else:
                    prog.run(k_pool, v_pool)

    def pool_bytes(self):
        """Bytes the allocator holds in the graphs' shared pool; 0 before
        the first capture."""
        return self._gpool.bytes()

    def graph_stats(self):
        """Per program (``"decode|K"``, ``"prefill|B|T"``, ...): the kernel
        launches its capture recorded (None off the card or before a
        capture) and its replays."""
        return {"|".join(map(str, key)): {
            "captured_launches": prog.captured_launches,
            "replays": prog.replays}
            for key, prog in sorted(self._programs.items())}

    # -- manifests -----------------------------------------------------------
    def manifest_dict(self, cache_dir=None, graphs=None):
        return {
            "version": MANIFEST_VERSION,
            "kind": "decode_engine",
            "env_signature": env_signature(),
            "torch_version": torch.__version__,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "prefill_batch": self.prefill_batch,
            "max_prompt_len": self.max_prompt_len,
            "page_tokens": self.page_tokens,
            "kv_pages": self.kv_pages,
            "speculate_k": self.speculate_k,
            "prefix_cache": self.prefix_cache,
            "tp": self.tp,
            "batch_ladder": list(self.batch_ladder),
            "len_ladder": list(self.len_ladder),
            "cache_shape": list(self.cache_shape),
            "cache_dtype": self.cache_dtype,
            "signatures": dict(sorted(self._signatures.items())),
            "cache_dir": cache_dir,
            "graphs": graphs,
            "created_unix": time.time(),
        }

    def export(self, prefix):
        raise MXNetError(f"exporting decode programs {_GRAPH_LAYER}")

    @classmethod
    def from_export(cls, prefix_or_manifest):
        raise MXNetError(
            f"serving decode programs from an export {_GRAPH_LAYER}")
