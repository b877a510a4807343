"""Enums and the model registry of the port.

Port of the part of ``enhax/constants.py`` that the Zero-DCE serving path
needs: the ``Task`` and ``Scheme`` enums and the ``MODELS`` registry.
"""

from __future__ import annotations

import enum

from enhax_torch.registry import ModelRegistry


class StrEnum(str, enum.Enum):
    """Enum whose members are strings."""

    def __str__(self) -> str:
        return self.value


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


MODELS = ModelRegistry("models")
