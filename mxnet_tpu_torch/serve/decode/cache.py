"""KV caches of the decode engine: slot/page allocators and the pools.

Counterpart of ``mxnet_tpu/serve/decode/cache.py``. The allocators are
host logic, copied as they are; the pools are torch tensors on the
engine's device (the GPU unless ``device="cpu"`` is passed). The
engine's programs update the pools in place, so
``rebind`` is a formality kept for API parity.
"""
from __future__ import annotations

import numpy as onp
import torch

from ...base import MXNetError, to_dtype
from ...context import resolve_device

__all__ = ["SlotAllocator", "KVCache", "PageAllocator", "PagedKVCache"]


class SlotAllocator:
    """LIFO free list over ``num_slots`` ids. LIFO (not FIFO) reuse keeps
    the live-slot set dense in recently-touched cache rows."""

    def __init__(self, num_slots):
        if num_slots < 1:
            raise MXNetError(f"need at least one slot, got {num_slots}")
        self.num_slots = int(num_slots)
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._live = set()

    def alloc(self):
        """Claim a slot id, or None when every slot is occupied."""
        if not self._free:
            return None
        sid = self._free.pop()
        self._live.add(sid)
        return sid

    def free(self, sid):
        if sid not in self._live:
            raise MXNetError(f"slot {sid} is not live (double free?)")
        self._live.remove(sid)
        self._free.append(sid)

    @property
    def live(self):
        return frozenset(self._live)

    @property
    def free_count(self):
        return len(self._free)

    def __len__(self):
        return self.num_slots


class KVCache:
    """Slot-cache pair ``[num_slots, layers, heads, max_len, head_dim]``
    plus the host per-slot length vector."""

    def __init__(self, shape, dtype="float32", device=None):
        shape = tuple(int(d) for d in shape)
        if len(shape) != 5:
            raise MXNetError(
                "KV cache shape must be [num_slots, layers, heads, max_len, "
                f"head_dim], got {shape}")
        self.num_slots = shape[0]
        self.max_len = shape[3]
        self.k = torch.zeros(shape, dtype=to_dtype(dtype),
                             device=resolve_device(device))
        self.v = torch.zeros_like(self.k)
        self.lengths = onp.zeros(self.num_slots, dtype="int32")
        self.slots = SlotAllocator(self.num_slots)

    def rebind(self, k, v):
        self.k, self.v = k, v

    @property
    def nbytes(self):
        return int(self.k.numel() * self.k.element_size() * 2)

    def occupancy(self):
        return len(self.slots.live) / self.num_slots


class PageAllocator:
    """LIFO free list over ``num_pages`` KV-pool page ids.

    ``alloc(n)`` is all-or-nothing: it hands back n page ids or None when
    the pool can't cover the request — the scheduler decides whether to
    evict prefix-cache pages, wait for retirements, or shed."""

    def __init__(self, num_pages):
        if num_pages < 1:
            raise MXNetError(f"need at least one page, got {num_pages}")
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._live = set()

    def alloc(self, n=1):
        """Claim ``n`` page ids (all-or-nothing); None when short."""
        if n < 0:
            raise MXNetError(f"cannot alloc {n} pages")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        return ids

    def free(self, ids):
        for pid in ids:
            if pid not in self._live:
                raise MXNetError(
                    f"page {pid} is not live (double free?)")
            self._live.remove(pid)
            self._free.append(pid)

    @property
    def live(self):
        return frozenset(self._live)

    @property
    def free_count(self):
        return len(self._free)

    def __len__(self):
        return self.num_pages


class PagedKVCache:
    """Paged KV pool pair on the device + the host page tables.

    The pools have shape ``[num_pages, layers, heads, page_tokens,
    head_dim]``; a slot's cache is one int32 page-table row of width
    ``W+1`` (W = ceil(max_len / page_tokens)) mapping logical page index to
    pool page id. ``trash`` (= num_pages, one past the pool) marks unmapped
    columns: writes routed there are dropped and reads clip to a real page
    whose positions the kv mask never admits. Column W is permanently
    trash.
    """

    def __init__(self, shape, dtype="float32", *, num_slots, max_len,
                 device=None):
        shape = tuple(int(d) for d in shape)
        if len(shape) != 5:
            raise MXNetError(
                "paged KV pool shape must be [num_pages, layers, heads, "
                f"page_tokens, head_dim], got {shape}")
        self.num_pages = shape[0]
        self.page_tokens = shape[3]
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_tokens)  # W
        self.trash = self.num_pages
        self.k = torch.zeros(shape, dtype=to_dtype(dtype),
                             device=resolve_device(device))
        self.v = torch.zeros_like(self.k)
        self.lengths = onp.zeros(self.num_slots, dtype="int32")
        self.table = onp.full((self.num_slots, self.pages_per_slot + 1),
                              self.trash, dtype="int32")
        self.slots = SlotAllocator(self.num_slots)
        self.pages = PageAllocator(self.num_pages)

    def rebind(self, k, v):
        self.k, self.v = k, v

    def reset_row(self, sid):
        self.table[sid, :] = self.trash
        self.lengths[sid] = 0

    @property
    def nbytes(self):
        return int(self.k.numel() * self.k.element_size() * 2)

    def occupancy(self):
        return len(self.slots.live) / self.num_slots

    def pages_live(self):
        return self.num_pages - self.pages.free_count
