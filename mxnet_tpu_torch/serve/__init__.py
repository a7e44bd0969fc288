"""Serving: shape bucketing and the continuous-batching decode engine."""
from . import bucketing, decode
from .bucketing import bucket_ladder, pick_bucket

__all__ = ["bucketing", "decode", "bucket_ladder", "pick_bucket"]
