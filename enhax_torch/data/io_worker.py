"""The predict CLI's source and writer.

Port of ``enhax/data/io_worker.py``: a registered dataset name builds that
dataset (``root`` and the split given); a folder or an image file an
``ImageLoader``; a video file a ``VideoLoader`` and, with ``dst``, a video
writer at the source's frame rate (``ops.video.make_video_writer``).
"""

from __future__ import annotations

from pathlib import Path

from enhax_torch.constants import DATASETS, IMAGE_EXTS, VIDEO_EXTS, Split
from enhax_torch.data.dataset import ImageLoader, VideoLoader


def parse_io_worker(src, dst=None, split=Split.TEST, transform=None, **kwargs):
    """Returns ``(source, writer or None)``."""
    src_str = str(src)
    if src_str in DATASETS:
        root = kwargs.pop("root", None)
        return DATASETS.get(src_str)(root, split=split, transform=transform, **kwargs), None
    path = Path(src_str)
    if path.is_dir() or (path.is_file() and path.suffix.lower() in IMAGE_EXTS):
        return ImageLoader(path, transform=transform), None
    if path.is_file() and path.suffix.lower() in VIDEO_EXTS:
        loader = VideoLoader(path, transform=transform)
        writer = None
        if dst is not None:
            from enhax_torch.ops.video import make_video_writer
            writer = make_video_writer(Path(dst), fps=loader.fps)
        return loader, writer
    raise ValueError(f"cannot resolve data source {src!r} (not a registered dataset, "
                     "directory, image or video)")
