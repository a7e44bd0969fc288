"""Host-side radix prefix cache over prompt token prefixes (SGLang-style).

A verbatim copy of ``mxnet_tpu/serve/decode/prefix.py``
(host logic only): the port keeps its own copy rather than importing
the JAX package.

A radix tree maps token-sequence prefixes to the KV-pool pages that
already hold their keys/values, so a request whose prompt shares a
templated system prompt with earlier traffic skips re-prefilling the
shared span: admission looks the prompt up, pins the matched path, maps
the shared pages into the new slot's page table (read-only), and
prefills only the suffix via the join program at the page-aligned
divergence offset.

Invariants the engine relies on:

- **Shared pages are never written.** A slot's in-program writes target
  positions >= its prompt length > the shared span, and the suffix
  scatter starts at the divergence page — so mapping a shared page into
  many tables concurrently is safe without copies.
- **Copy-on-write by recompute.** A divergent request never mutates a
  shared boundary page: its join starts at the last page-ALIGNED shared
  offset, recomputing its own copy of any partially-shared page into a
  private page. Divergence therefore costs at most one page of redundant
  prefill, and no page is ever cloned on device.
- **Refcounted eviction.** Every node on a request's matched/inserted
  path carries a pin (refcount) for the request's lifetime; ``evict``
  only frees LRU leaves with refcount 0, returning their page ids to the
  allocator. A page id lives in exactly one tree node, so eviction frees
  each page exactly once.

Pages are keyed by ABSOLUTE page index (position // page_tokens) and
attached to the deepest path node their last token reaches; a node split
keeps straddling pages with the deeper (original continuation) part, so
a later match can only use page j after matching the full prompt through
token (j+1) * page_tokens — partial-page hits never leak.
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["RadixPrefixCache"]


class _Node:
    __slots__ = ("tokens", "children", "pages", "refs", "last_used",
                 "parent")

    def __init__(self, tokens, parent):
        self.tokens = list(tokens)   # edge label INTO this node
        self.children = {}           # first token -> _Node
        self.pages = {}              # absolute page index -> pool page id
        self.refs = 0                # live requests pinning this node
        self.last_used = 0
        self.parent = parent


class RadixPrefixCache:
    """Single-threaded (scheduler-owned) radix tree; see module docstring.

    ``page_tokens`` is the pool page size; all page bookkeeping is in
    absolute page indices over the prompt. A monotonic counter stands in
    for time in LRU ordering (deterministic, no clock reads).
    """

    def __init__(self, page_tokens):
        self.page_tokens = int(page_tokens)
        if self.page_tokens < 1:
            raise MXNetError(f"page_tokens must be >= 1, got {page_tokens}")
        self.root = _Node([], None)
        self._clock = 0
        self.hits = 0
        self.hit_tokens = 0

    # ------------------------------------------------------------------ walk
    def _tick(self):
        self._clock += 1
        return self._clock

    def _walk(self, tokens):
        """Longest match walk. Returns (matched_len, path, partial) where
        ``path`` is the fully-or-partially matched node chain (root
        excluded) and ``partial`` the offset into the last node's edge
        (0 = fully matched)."""
        node, depth, path = self.root, 0, []
        while depth < len(tokens):
            nxt = node.children.get(tokens[depth])
            if nxt is None:
                return depth, path, 0
            edge = nxt.tokens
            n = 0
            limit = min(len(edge), len(tokens) - depth)
            while n < limit and edge[n] == tokens[depth + n]:
                n += 1
            depth += n
            path.append(nxt)
            if n < len(edge):
                return depth, path, n
            node = nxt
        return depth, path, 0

    # ----------------------------------------------------------------- match
    def match(self, tokens, pin=True):
        """Longest reusable page-aligned prefix of ``tokens``.

        Returns ``(matched_tokens, page_ids, handle)``: ``page_ids`` maps
        absolute page index j (contiguous from 0) to a pool page id for
        every full page inside the match, ``matched_tokens`` =
        len(page_ids) * page_tokens, capped so at least one suffix token
        remains to prefill. ``handle`` pins the supporting path until
        :meth:`release` (None when ``pin`` is False or on a miss).
        """
        P = self.page_tokens
        depth, path, _ = self._walk(tokens)
        now = self._tick()
        avail = {}
        for node in path:
            for j, pid in node.pages.items():
                if (j + 1) * P <= depth:
                    avail[j] = pid
            node.last_used = now
        # usable prefix must be contiguous full pages from 0, and leave
        # >= 1 token of suffix for the join program's last-logit select
        cap = (len(tokens) - 1) // P
        run = 0
        while run < cap and run in avail:
            run += 1
        if run == 0:
            return 0, [], None
        pages = [avail[j] for j in range(run)]
        matched = run * P
        # pin only the path prefix actually supporting the used pages
        need = set(pages)
        handle = []
        for node in path:
            handle.append(node)
            need -= set(node.pages.values())
            if not need:
                break
        if pin:
            for node in handle:
                node.refs += 1
        else:
            handle = None
        self.hits += 1
        self.hit_tokens += matched
        return matched, pages, handle

    def release(self, handle):
        if not handle:
            return
        for node in handle:
            node.refs -= 1
            if node.refs < 0:
                raise MXNetError("radix node refcount underflow")

    # ---------------------------------------------------------------- insert
    def _split(self, node, offset):
        """Split ``node``'s edge at ``offset``; returns the new parent.
        Straddling pages stay with ``node`` (the deeper part)."""
        parent = node.parent
        mid = _Node(node.tokens[:offset], parent)
        node.tokens = node.tokens[offset:]
        node.parent = mid
        mid.children[node.tokens[0]] = node
        parent.children[mid.tokens[0]] = mid
        # mid starts unpinned: pins on ``node`` still protect it
        # structurally — eviction only removes refcount-0 LEAVES, and mid
        # has ``node`` as a child for as long as any handle pins it
        mid.last_used = node.last_used
        # depth of mid's end = depth(parent end) + offset; pages whose
        # last token is inside mid's span move to mid
        end = self._depth(mid)
        moved = {j: pid for j, pid in node.pages.items()
                 if (j + 1) * self.page_tokens <= end}
        for j in moved:
            del node.pages[j]
        mid.pages.update(moved)
        return mid

    def _depth(self, node):
        d = 0
        while node is not None:
            d += len(node.tokens)
            node = node.parent
        return d

    def insert(self, tokens, pages, pin=True):
        """Record that full pages ``{abs_index: page_id}`` of ``tokens``
        are resident. Returns ``(handle, adopted)``: ``adopted`` is the
        set of absolute page indices whose ids the tree took ownership of
        (the caller must stop freeing those); indices already covered by
        an equal-prefix insert are NOT adopted (the caller keeps its
        duplicate private). ``handle`` pins the path (release to unpin).
        """
        P = self.page_tokens
        for j in pages:
            if (j + 1) * P > len(tokens):
                raise MXNetError(
                    f"page {j} is not a full page of a {len(tokens)}-token "
                    "prompt")
        depth, path, partial = self._walk(tokens)
        node = path[-1] if path else self.root
        if partial:
            node = self._split(node, partial)
            path[-1] = node
        if depth < len(tokens):
            leaf = _Node(tokens[depth:], node)
            node.children[leaf.tokens[0]] = leaf
            path.append(leaf)
        now = self._tick()
        adopted = set()
        if path:
            # attach each offered page to the deepest node containing its
            # last token
            bounds = []
            d = 0
            for n in path:
                d += len(n.tokens)
                bounds.append((d, n))
            have = set()
            for n in path:
                have |= set(n.pages)
                n.last_used = now
            for j, pid in sorted(pages.items()):
                if j in have:
                    continue
                for d, n in bounds:
                    if (j + 1) * P <= d:
                        n.pages[j] = pid
                        adopted.add(j)
                        break
        handle = None
        if pin and path:
            handle = list(path)
            for n in handle:
                n.refs += 1
        return handle, adopted

    # ----------------------------------------------------------------- evict
    def _leaves(self):
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evictable_pages(self):
        """Pages reclaimable right now (unpinned leaf chains)."""
        total = 0
        for leaf in self._leaves():
            n = leaf
            while n is not self.root and n.refs == 0:
                total += len(n.pages)
                # parent only counts if this is its sole child
                if n.parent is self.root or len(n.parent.children) > 1:
                    break
                n = n.parent
        return total

    def evict(self, need):
        """Free >= ``need`` pages if possible, LRU leaf chains first.
        Returns the freed pool page ids (possibly fewer than ``need``)."""
        freed = []
        while len(freed) < need:
            cands = [n for n in self._leaves() if n.refs == 0]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.last_used)
            freed.extend(victim.pages.values())
            del victim.parent.children[victim.tokens[0]]
            victim.parent = None
        return freed

    # ------------------------------------------------------------- reporting
    def stats(self):
        nodes = pages = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                nodes += 1
                pages += len(n.pages)
            stack.extend(n.children.values())
        return {"nodes": nodes, "pages": pages, "hits": self.hits,
                "hit_tokens": self.hit_tokens}
