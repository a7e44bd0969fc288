"""Shape bucketing: bound the compiled-program set to a batch-size ladder.

A verbatim copy of ``mxnet_tpu/serve/bucketing.py``
(host logic only): the port keeps its own copy rather than importing
the JAX package.

Every novel batch shape retraces a compiled program and pays a fresh XLA
compile; unconstrained traffic therefore grows the jit cache without bound
(TVM's ahead-of-time per-shape specialization, arxiv 1802.04799, is the
precedent for fixing the shape set up front). The ladder bounds it to
O(log max_batch) programs: an incoming batch of n rows is padded with
zeros up to the smallest bucket >= n, and outputs are sliced back to n.
Batches larger than ``max_batch`` split into max_batch-sized chunks plus
one ragged tail.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["bucket_ladder", "pick_bucket", "split_sizes", "padded_rows"]


def bucket_ladder(max_batch, min_bucket=1):
    """Ascending bucket sizes: powers of two from ``min_bucket`` capped by
    ``max_batch`` (always included, even when not a power of two).

    >>> bucket_ladder(64)
    [1, 2, 4, 8, 16, 32, 64]
    >>> bucket_ladder(48, min_bucket=4)
    [4, 8, 16, 32, 48]
    """
    max_batch, min_bucket = int(max_batch), int(min_bucket)
    if max_batch < 1 or min_bucket < 1:
        raise MXNetError(
            f"bucket ladder needs positive sizes, got max_batch={max_batch} "
            f"min_bucket={min_bucket}")
    if min_bucket > max_batch:
        raise MXNetError(
            f"min_bucket {min_bucket} exceeds max_batch {max_batch}")
    ladder, b = [], min_bucket
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def pick_bucket(n, ladder):
    """Smallest bucket >= n (ladder is ascending); None when n overflows
    the ladder (the caller splits such batches first)."""
    for b in ladder:
        if b >= n:
            return b
    return None


def split_sizes(n, max_batch):
    """Chunk a batch of n rows into dispatchable sizes:
    full ``max_batch`` chunks plus one ragged tail.

    >>> split_sizes(70, 32)
    [32, 32, 6]
    """
    if n < 1:
        raise MXNetError(f"cannot serve an empty batch (n={n})")
    sizes = [max_batch] * (n // max_batch)
    if n % max_batch:
        sizes.append(n % max_batch)
    return sizes


def padded_rows(n, bucket):
    """Rows of zero-padding a batch of n pays in its bucket."""
    return bucket - n
