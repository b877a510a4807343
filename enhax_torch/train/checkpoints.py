"""Checkpoint save and restore, and the newest checkpoint of a directory.

Port of ``enhax/train/checkpoints.py``. A checkpoint is a directory
``ckpt_dir/<name>`` (``last``, ``best``) holding ``state.pt``: a
``torch.save`` of the step, the epoch, the module's ``state_dict``, the
optimizer's ``state_dict``, when training with EMA the shadow's and, saved
inside a cycle of ``accumulate_grad_batches``, the gradients summed so far
(``grads``: optax's ``MultiSteps`` keeps them in its state). It is written
to a temporary file and renamed, so a run cut while saving leaves the
previous checkpoint whole. The JAX package writes orbax directories;
``convert.from_jax.jax_checkpoint_to_torch`` (``tools/jax_ckpt_to_torch.py``)
turns one into this payload.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir, state, epoch: int, name: str = "last") -> Path:
    """Save a ``TrainState`` under ``ckpt_dir/<name>/state.pt``."""
    path = Path(ckpt_dir).absolute() / name
    path.mkdir(parents=True, exist_ok=True)
    payload = {"step": int(state.step), "epoch": int(epoch),
               "model": state.module.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    if state.ema is not None:
        payload["ema"] = state.ema.state_dict()
    if state.step % state.accumulate_grad_batches:
        payload["grads"] = {n: p.grad for n, p in state.module.named_parameters()
                            if p.grad is not None}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)
    return path


def load_checkpoint(path, state):
    """Restore ``state`` in place from the checkpoint directory ``path``;
    return ``(state, epoch + 1)``. A checkpoint of another model raises
    (``load_state_dict`` is strict). A checkpoint without an EMA shadow
    seeds the shadow from its parameters; one with a shadow restored by a
    trainer without EMA drops it. The gradients of an unfinished
    accumulation cycle go back into ``.grad``."""
    device = next(state.module.parameters()).device
    payload = torch.load(Path(path) / STATE_FILE, map_location=device, weights_only=True)
    state.module.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.ema is not None:
        state.ema.load_state_dict(payload.get("ema", payload["model"]))
    state.step = int(payload["step"])
    grads = payload.get("grads", {})
    for name, p in state.module.named_parameters():
        p.grad = torch.empty_like(p).copy_(grads[name]) if name in grads else None
    return state, int(payload["epoch"]) + 1


def latest_checkpoint(ckpt_dir) -> Path | None:
    """``ckpt_dir/last`` if it holds a checkpoint, else the newest by mtime."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    cands = [d for d in ckpt_dir.iterdir() if (d / STATE_FILE).is_file()]
    if not cands:
        return None
    last = ckpt_dir / "last"
    if last in cands:
        return last
    return max(cands, key=lambda d: (d / STATE_FILE).stat().st_mtime)
