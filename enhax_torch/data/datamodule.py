"""DataModule, batch iteration and prefetch to the device.

Port of ``enhax/data/datamodule.py``: numpy batch iterators with per-epoch
shuffling (``np.random.default_rng(seed + epoch)``, the JAX package's order
for the same seed), the samples of a batch decoded on a thread pool, and
``prefetch_to_device``: a background thread that collates, pins and copies
batches to the device ``non_blocking`` while the device computes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from enhax_torch.constants import Split
from enhax_torch.data.annotation import collate_datapoints


def batch_iterator(dataset, batch_size: int = 8, shuffle: bool = False,
                   drop_last: bool = False, seed: int = 0,
                   collate_fn: Callable | None = None,
                   num_workers: int = 0) -> Iterator[dict]:
    """Yield collated numpy batch dicts from a map-style dataset.

    ``num_workers > 0`` decodes a batch's samples on a thread pool
    (``dataset.load``, the port's ``Dataset``; indexing otherwise) and
    applies ``dataset.apply_transform`` on this thread in index order, so a
    random transform draws in the same order and the batches do not depend
    on ``num_workers``.
    """
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    collate = collate_fn or collate_datapoints
    sels = [idx[s : s + batch_size] for s in range(0, n, batch_size)]
    if drop_last and sels and len(sels[-1]) < batch_size:
        sels.pop()
    if not num_workers:
        for sel in sels:
            yield collate([dataset[int(i)] for i in sel])
        return
    load = getattr(dataset, "load", dataset.__getitem__)
    transform = getattr(dataset, "apply_transform", lambda item: item)
    with ThreadPoolExecutor(max_workers=int(num_workers)) as pool:
        for sel in sels:
            yield collate([transform(item) for item in pool.map(load, map(int, sel))])


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on ``device`` (pinned and copied
    ``non_blocking`` to a CUDA device); other entries (``meta``) dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
    return out


_END = object()


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator[dict]:
    """Collate and copy the next ``size`` batches on a background thread
    while the caller computes; an error in the thread is raised here. A
    copy is ordered on the device's current stream before any work the
    caller enqueues later on it."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(to_device(batch, device)):
                    return
        except BaseException as e:  # noqa: BLE001  (re-raised by the consumer)
            put(e)
            return
        put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)


class DataModule:
    """Builds the splits' datasets from ``dataset_cls`` and their iterators."""

    tasks: tuple = ()
    dataset_cls = None
    dataset_splits: tuple = (Split.TRAIN, Split.TEST)

    def __init__(self, root=None, batch_size: int = 8, shuffle: bool = True,
                 transform=None, val_transform=None, drop_last: bool = False,
                 seed: int = 0, verbose: bool = False, num_workers: int = 0,
                 **dataset_kwargs):
        self.root = root
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.val_transform = val_transform
        self.drop_last = drop_last
        self.seed = seed
        self.verbose = verbose
        self.num_workers = num_workers
        self.dataset_kwargs = dataset_kwargs
        self.train = self.val = self.test = None
        self._train_loader_calls = 0

    def setup(self, stage: str | None = None):
        cls = self.dataset_cls
        if cls is None:
            raise ValueError(f"{type(self).__name__} has no dataset_cls")
        has_val = Split.VAL in self.dataset_splits
        has_test = Split.TEST in self.dataset_splits

        def try_build(split, transform):
            try:
                return cls(self.root, split=split, transform=transform,
                           verbose=self.verbose, **self.dataset_kwargs)
            except RuntimeError:
                return None  # the split is not on disk

        if stage in (None, "train"):
            self.train = cls(self.root, split=Split.TRAIN, transform=self.transform,
                             verbose=self.verbose, **self.dataset_kwargs)
            val_split = Split.VAL if has_val else (Split.TEST if has_test else Split.TRAIN)
            self.val = try_build(val_split, self.val_transform)
        if stage in (None, "test"):
            self.test = try_build(Split.TEST if has_test else Split.TRAIN, self.val_transform)
        return self

    def train_loader(self):
        """A new shuffle each call: the Trainer calls it once an epoch."""
        epoch = self._train_loader_calls
        self._train_loader_calls += 1
        return batch_iterator(self.train, self.batch_size, shuffle=self.shuffle,
                              drop_last=self.drop_last, seed=self.seed + epoch,
                              num_workers=self.num_workers)

    def val_loader(self):
        return batch_iterator(self.val, self.batch_size, shuffle=False,
                              num_workers=self.num_workers)

    def summarize(self):
        for name in ("train", "val", "test"):
            ds = getattr(self, name)
            if ds is not None:
                print(f"[data] {type(self).__name__} {name}: {len(ds)} items "
                      f"({type(ds).__name__})")
