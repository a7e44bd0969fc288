"""Vision datasets + transforms (reference: gluon/data/vision/)."""
from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset,
                       ImageListDataset)

__all__ = ["transforms", "MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageListDataset",
           "ImageFolderDataset"]
