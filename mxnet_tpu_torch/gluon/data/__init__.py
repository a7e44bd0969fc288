"""gluon.data (reference: python/mxnet/gluon/data/): datasets, samplers,
batchify functions, the DataLoader, the DevicePrefetcher and vision."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      IntervalSampler, FilterSampler)
from .dataloader import DataLoader, default_batchify_fn
from .prefetcher import DevicePrefetcher
from . import batchify
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FilterSampler", "DataLoader",
           "DevicePrefetcher", "default_batchify_fn", "batchify", "vision"]
