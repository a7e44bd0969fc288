"""Serving: shape bucketing, the ``Predictor`` of hybridized blocks and the
continuous-batching decode engine."""
from . import bucketing, decode
from .bucketing import bucket_ladder, pick_bucket, split_sizes
from .decode import DecodeEngine, DecodeStream, EngineDeadError, ShedError
from .predictor import Predictor, load_manifest

__all__ = ["Predictor", "load_manifest", "bucket_ladder", "pick_bucket",
           "split_sizes", "bucketing", "decode", "DecodeEngine",
           "DecodeStream", "ShedError", "EngineDeadError"]
