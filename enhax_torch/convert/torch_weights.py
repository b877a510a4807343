"""Reading released torch checkpoints into a flat state dict.

Port of the loading half of ``enhax/convert/torch_weights.py``: the
nestings released checkpoints use (``unwrap_state_dict``) and the
weights-only-first read (``read_torch_checkpoint``). The port's modules
carry the reference torch names, so the unwrapped dict loads as it is.
"""

from __future__ import annotations

import numpy as np
import torch

NESTING_KEYS = ("state_dict", "params_ema", "params", "model", "model_state_dict", "net")
PREFIXES = ("module.", "_orig_mod.")
CHECKPOINT_SUFFIXES = (".pt", ".pth", ".ckpt")


def unwrap_state_dict(ckpt) -> dict:
    """A flat {name: tensor} dict from a released checkpoint.

    Takes the first of ``NESTING_KEYS`` whose value is a non-empty dict of
    arrays: ``state_dict`` (lightning), ``params_ema`` before ``params``
    (BasicSR: the EMA weights are the released inference weights), ``model``,
    ``model_state_dict``, ``net``. Strips the DataParallel and
    ``torch.compile`` prefixes ``module.`` and ``_orig_mod.``."""
    sd = ckpt
    if isinstance(sd, dict):
        for key in NESTING_KEYS:
            inner = sd.get(key)
            if isinstance(inner, dict) and inner and all(
                    hasattr(v, "shape") or isinstance(v, np.ndarray) for v in inner.values()):
                sd = inner
                break
    if not isinstance(sd, dict):
        raise ValueError(f"cannot interpret checkpoint of type {type(sd)} as a state dict")
    out = {}
    for k, v in sd.items():
        for pre in PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def read_torch_checkpoint(path) -> dict:
    """``unwrap_state_dict`` of a ``.pt``/``.pth``/``.ckpt`` file, read on
    the CPU. ``weights_only=True`` first; a file that needs more is read
    with a full unpickle after a printed warning (trusted files only)."""
    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:
        print(f"[convert] WARNING: {path} is not weights-only; falling back to a full "
              "pickle load (trusted files only)")
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    return unwrap_state_dict(ckpt)
