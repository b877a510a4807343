"""Datasets, transforms and datamodules of the port. Importing this package
registers the dataset table in ``DATASETS`` and ``DATAMODULES``."""

from enhax_torch.data import datasets  # noqa: F401  (populates the registries)
from enhax_torch.data.datamodule import DataModule, batch_iterator, prefetch_to_device
from enhax_torch.data.dataset import Dataset, MultimodalDataset
from enhax_torch.data.transforms import Compose, RandomCrop, RandomFlip

__all__ = ["Compose", "DataModule", "Dataset", "MultimodalDataset", "RandomCrop",
           "RandomFlip", "batch_iterator", "prefetch_to_device"]
