"""Enums, directories and the registries of the port.

Port of the part of ``enhax/constants.py`` that serving and training need:
``RUN_DIR``, ``DATA_DIR``, the ``Task``, ``Scheme`` and ``Split`` enums, the
image and video file extensions, and the ``MODELS``, ``DATASETS``, ``DATAMODULES``, ``LOSSES``,
``METRICS``, ``OPTIMIZERS``, ``LR_SCHEDULERS``, ``CALLBACKS`` and ``LOGGERS``
registries.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path

from enhax_torch.registry import ModelRegistry, Registry

ROOT_DIR = Path(__file__).resolve().parents[1]
RUN_DIR = Path(os.environ.get("RUN_DIR", ROOT_DIR / "run"))

IMAGE_EXTS = (".arw", ".bmp", ".dng", ".jpg", ".jpeg", ".png", ".ppm", ".raf",
              ".tif", ".tiff", ".webp")
VIDEO_EXTS = (".avi", ".m4v", ".mkv", ".mov", ".mp4", ".mpeg", ".mpg", ".wmv")
# where the predict CLI's --use-data-dir resolves a relative --data
DATA_DIR = Path(os.environ.get("DATA_DIR", ROOT_DIR / "data"))


class StrEnum(str, enum.Enum):
    """Enum whose members are strings, constructible from value or name."""

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_value(cls, value) -> "StrEnum":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            v = value.strip().lower()
            for m in cls:
                if m.value == v or m.name.lower() == v:
                    return m
        raise ValueError(f"{cls.__name__}: unknown value {value!r}")


class Task(StrEnum):
    """Vision tasks."""
    CLASSIFY = "classify"
    DEBLUR = "deblur"
    DEHAZE = "dehaze"
    DENOISE = "denoise"
    DEPTH = "depth"
    DERAIN = "derain"
    DESNOW = "desnow"
    DETECT = "detect"
    INPAINT = "inpaint"
    LES = "les"           # light effect suppression
    LLIE = "llie"         # low-light image enhancement
    NIGHTTIME = "nighttime"
    POSE = "pose"
    RETOUCH = "retouch"
    SEGMENT = "segment"
    SR = "sr"
    TRACK = "track"


class Scheme(StrEnum):
    """Learning schemes."""
    INFERENCE = "inference"
    INSTANCE = "instance"            # per-image test-time optimization
    SUPERVISED = "supervised"
    TRADITIONAL = "traditional"
    UNSUPERVISED = "unsupervised"
    ZERO_REFERENCE = "zero_reference"
    ZERO_SHOT = "zero_shot"


class Split(StrEnum):
    """Dataset splits."""
    TRAIN = "train"
    VAL = "val"
    TEST = "test"
    PREDICT = "predict"


MODELS = ModelRegistry("models")
DATASETS = Registry("datasets")
DATAMODULES = Registry("datamodules")
LOSSES = Registry("losses")
METRICS = Registry("metrics")
OPTIMIZERS = Registry("optimizers")
LR_SCHEDULERS = Registry("lr_schedulers")
CALLBACKS = Registry("callbacks")
LOGGERS = Registry("loggers")
