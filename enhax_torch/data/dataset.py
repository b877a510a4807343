"""Dataset bases: map-style datasets over annotation lists, with companion
modalities found by path rewriting.

Port of ``Dataset`` and ``MultimodalDataset`` from ``enhax/data/dataset.py``.
A subclass fills ``self.datapoints`` (attribute -> list of annotations) in
``get_data``; ``MultimodalDataset`` derives ``ref_image`` from the nearest
``ref``/``hq``/``gt``/``high``/``target``/``clean`` sibling folder and
``depth`` from ``{folder}_{depth_source}``, matched by file stem, and
``filter_data`` drops items missing a required companion.

``ImageLoader`` (an unlabeled folder or one image) and ``VideoLoader``
(frames streamed from a video) are the predict CLI's sources
(``data/io_worker.py``).

``load(i)`` decodes item i; ``__getitem__(i)`` is ``load(i)`` then the
transform. ``datamodule.batch_iterator`` decodes a batch's items on a
thread pool and applies the transforms in index order on the calling
thread, so a random transform draws in the same order however many threads
decode.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from enhax_torch.constants import IMAGE_EXTS, Split
from enhax_torch.data.annotation import DatapointAttributes, DepthMapAnnotation, ImageAnnotation


def image_files(directory: Path) -> list[Path]:
    """Image files under ``directory``, recursively, sorted."""
    return sorted(p for p in Path(directory).rglob("*")
                  if p.is_file() and p.suffix.lower() in IMAGE_EXTS)


class Dataset:
    """Map-style dataset over annotation lists."""

    tasks: tuple = ()
    splits: tuple = (Split.TRAIN, Split.VAL, Split.TEST)
    datapoint_attrs = DatapointAttributes()
    has_test_annotations: bool = False

    def __init__(self, root, split=Split.TRAIN, transform=None, verbose: bool = False):
        self.root = Path(root)
        self.split = Split.from_value(split)
        self.transform = transform
        self.verbose = verbose
        self.datapoints: dict[str, list] = {k: [] for k in self.datapoint_attrs}
        self.get_data()
        self.filter_data()
        self.verify_data()

    def get_data(self):
        raise NotImplementedError

    def filter_data(self):
        pass

    def verify_data(self):
        """Non-empty, and every attribute as long as the main one."""
        lengths = {k: len(v) for k, v in self.datapoints.items() if v}
        if not lengths:
            raise RuntimeError(f"{type(self).__name__}: no data found under {self.root}")
        n = len(self)
        for k, count in lengths.items():
            if count != n:
                raise RuntimeError(f"{type(self).__name__}: attribute {k!r} has {count} "
                                   f"items, expected {n}")
        if self.verbose:
            print(f"[data] {type(self).__name__}/{self.split}: {n} items")

    def __len__(self) -> int:
        return len(self.datapoints.get(self.main_attribute, []))

    @property
    def main_attribute(self) -> str:
        return next(iter(self.datapoint_attrs), "image")

    def load(self, index: int) -> dict:
        """Item ``index`` decoded, before the transform."""
        item: dict[str, Any] = {}
        meta = {}
        for attr, anns in self.datapoints.items():
            ann = anns[index] if index < len(anns) else None
            if ann is None:
                item[attr] = None
                continue
            item[attr] = ann.data
            if attr == self.main_attribute:
                meta = {**ann.meta, "shape": item[attr].shape}
        item["meta"] = meta
        return item

    def apply_transform(self, item: dict) -> dict:
        return self.transform(item) if self.transform is not None else item

    def __getitem__(self, index: int) -> dict:
        return self.apply_transform(self.load(index))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class MultimodalDataset(Dataset):
    """A dataset whose companions are found by path rewriting."""

    datapoint_attrs = DatapointAttributes(image=ImageAnnotation)
    depth_source: str = "dav2_vitb_g"
    ref_dir_names: tuple = ("ref", "hq", "gt", "high", "target", "clean")

    def derive_ref_images(self):
        refs = [self._find_companion(ann.path, self.ref_dir_names)
                for ann in self.datapoints.get("image", [])]
        if any(r is not None for r in refs):
            self.datapoints["ref_image"] = refs

    def derive_depth(self):
        depths = []
        for ann in self.datapoints.get("image", []):
            parent = ann.path.parent
            c = self._match_stem(parent.with_name(f"{parent.name}_{self.depth_source}"),
                                 ann.path.stem)
            depths.append(None if c is None else DepthMapAnnotation(c, source=self.depth_source))
        if any(d is not None for d in depths):
            self.datapoints["depth"] = depths

    def _find_companion(self, path: Path, dir_names: tuple) -> ImageAnnotation | None:
        parent = path.parent
        for name in dir_names:
            for cand_dir in (parent.with_name(name), parent.parent / name):
                c = self._match_stem(cand_dir, path.stem)
                if c is not None:
                    return ImageAnnotation(c)
        return None

    @staticmethod
    def _match_stem(directory: Path, stem: str) -> Path | None:
        if not directory.is_dir():
            return None
        for ext in IMAGE_EXTS:
            c = directory / f"{stem}{ext}"
            if c.is_file():
                return c
        return None

    def filter_data(self):
        """Drop items missing a companion of a declared attribute."""
        required = [k for k in self.datapoint_attrs if k in self.datapoints]
        n = len(self.datapoints.get("image", []))
        keep = [i for i in range(n)
                if not any(i < len(self.datapoints.get(k, [])) and self.datapoints[k][i] is None
                           for k in required)]
        if len(keep) != n:
            for k, lst in self.datapoints.items():
                if lst:
                    self.datapoints[k] = [lst[i] for i in keep]


class ImageLoader(Dataset):
    """An unlabeled folder of images (recursive) or one image, for predict."""

    datapoint_attrs = DatapointAttributes(image=ImageAnnotation)
    splits = (Split.PREDICT,)

    def __init__(self, root, **kwargs):
        kwargs.setdefault("split", Split.PREDICT)
        super().__init__(root, **kwargs)

    def get_data(self):
        files = image_files(self.root) if self.root.is_dir() else [self.root]
        self.datapoints["image"] = [ImageAnnotation(f) for f in files]


class VideoLoader:
    """Frames of a video as datapoints ``{"image": HWC float32, "meta":
    {...}}``, streamed through ``ops.video.VideoReaderCV``; ``meta`` names
    frame i ``<stem>_<i:06d>.png``."""

    def __init__(self, path, transform=None):
        from enhax_torch.ops.video import VideoReaderCV
        self.path = Path(path)
        self.reader = VideoReaderCV(self.path)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.reader)

    @property
    def fps(self) -> float:
        return self.reader.fps

    def __iter__(self):
        for i, frame in enumerate(self.reader):
            item = {"image": frame,
                    "meta": {"index": i, "path": str(self.path),
                             "stem": f"{self.path.stem}_{i:06d}",
                             "name": f"{self.path.stem}_{i:06d}.png", "shape": frame.shape}}
            yield self.transform(item) if self.transform is not None else item
