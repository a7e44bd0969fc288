"""Speculative multi-token decoding: draft proposal + greedy verification.

A verbatim copy of ``mxnet_tpu/serve/decode/spec.py``
(host logic only): the port keeps its own copy rather than importing
the JAX package.

The ``decode_tick_k`` program feeds K tokens per slot — column 0 the last
committed token, columns 1..K-1 a cheap host-side draft — and returns the
target model's argmax at every column in ONE batched pass. Greedy
accept-longest-prefix then commits the draft prefix the target agrees
with plus the target's own next token, so the committed sequence is
BITWISE the plain greedy sequence: column i's argmax is conditioned only
on committed tokens and draft columns < i, and a column is accepted only
when every draft token before it matched the target's argmax chain. A
worthless draft still commits 1 token per tick (the plain tick); a
perfect draft commits K. K is static — speculation adds exactly one
program shape, keeping the zero-recompile serving contract.

Drafts (``MXTPU_DECODE_DRAFT``):

- ``ngram`` (default): propose the continuation that followed the most
  recent earlier occurrence of the context's trailing n-gram (n = 3, 2,
  1 in order), falling back to repeating the last token. Free, surprisingly
  strong on templated/self-repetitive serving traffic.
- ``last``: repeat the last token K-1 times (the degenerate baseline).
"""
from __future__ import annotations

from ...base import MXNetError

__all__ = ["NgramDraft", "LastTokenDraft", "make_draft",
           "accept_longest_prefix"]


def accept_longest_prefix(draft, argmax_row):
    """Tokens committable from one speculative tick.

    ``draft``: the K-1 proposed tokens fed at columns 1..K-1;
    ``argmax_row``: the program's K argmax outputs. Returns m >= 1:
    commit ``argmax_row[:m]``. Column i's output is valid only when the
    token fed at column i matched the chain, i.e. draft[i-1] ==
    argmax_row[i-1]; m counts the valid prefix.
    """
    m = 1
    k = len(argmax_row)
    while m < k and int(draft[m - 1]) == int(argmax_row[m - 1]):
        m += 1
    return m


class LastTokenDraft:
    """Degenerate draft: repeat the last committed token."""

    name = "last"

    def propose(self, context, n):
        return [int(context[-1])] * n


class NgramDraft:
    """Suffix-matching n-gram draft over the request's own context.

    For each proposed token, find the most recent PRIOR occurrence of the
    context's trailing n-gram (longest n first) and propose the token
    that followed it; each proposal is appended to the working context so
    a single lookup can draft a whole span. O(len * n) per token over
    contexts bounded by max_len — host-side noise next to a tick.
    """

    name = "ngram"

    def __init__(self, max_n=3):
        if max_n < 1:
            raise MXNetError(f"ngram draft needs max_n >= 1, got {max_n}")
        self.max_n = int(max_n)

    def _next(self, ctx):
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), 0, -1):
            tail = ctx[L - n:]
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    return ctx[i + n]
        return ctx[-1]

    def propose(self, context, n):
        work = [int(t) for t in context]
        out = []
        for _ in range(n):
            t = int(self._next(work))
            out.append(t)
            work.append(t)
        return out


def make_draft(name):
    name = (name or "ngram").strip().lower()
    if name == "ngram":
        return NgramDraft()
    if name == "last":
        return LastTokenDraft()
    raise MXNetError(
        f"unknown draft {name!r} (MXTPU_DECODE_DRAFT): expected 'ngram' "
        "or 'last'")
