"""Trainer hooks, the port's callbacks.

Port of ``enhax/train/hooks.py``. A hook is a callable ``hook(trainer,
state, row)`` that ``Trainer.fit`` calls after each epoch, after the CSV
log and before the checkpoint; it may add keys to ``row`` (they reach the
next CSV write) and lower ``trainer.max_epochs`` to stop the run. Each is
registered in ``CALLBACKS`` (the CSV and TensorBoard writers also in
``LOGGERS``) under the JAX package's names and aliases:

  * ``ProgressiveTrainingHook``: Restormer's progressive patches, the
    DataModule's crop and batch size for the next epoch;
  * ``EarlyStopHook``, ``TimerHook``: stop on a stagnant metric or a spent
    budget; ``LearningRateMonitorHook``: the lr into the row;
  * ``ModelCheckpointHook``: the trainer's monitor and directory from a
    config; ``CSVLogHook``: the rows to another CSV; ``DebugImageHook``:
    input | output | ref images;
  * ``SWAHook``: the running mean of the parameters in a module copy,
    checkpointed as ``swa``; ``TensorBoardHook``: scalars and images
    (``torch.utils.tensorboard``, imported at the first call).
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from enhax_torch.constants import CALLBACKS, LOGGERS


def _forward(trainer, module: torch.nn.Module, batch: dict) -> dict:
    """The model's inference forward of ``module`` on a numpy batch moved to
    the trainer's device."""
    from enhax_torch.data.datamodule import to_device
    model = dataclasses.replace(trainer.model, module=module)
    with torch.inference_mode():
        return model.apply(to_device(batch, trainer.device))


@CALLBACKS.register(name="debug_image")
class DebugImageHook:
    """input | output | ref side by side, every ``every_n_epochs`` epochs,
    to ``save_dir/debug/epoch_NNNN/III.jpg``."""

    def __init__(self, batch: dict, every_n_epochs: int = 1, max_items: int = 4,
                 out_key: str = "enhanced"):
        self.batch = batch
        self.every = max(every_n_epochs, 1)
        self.max_items = max_items
        self.out_key = out_key

    def __call__(self, trainer, state, row):
        epoch = row["epoch"]
        if epoch % self.every or not trainer.save_dir:
            return
        from enhax_torch.ops.io import write_image
        out = _forward(trainer, state.module, self.batch)[self.out_key]
        pred = out.float().clamp(0, 1).cpu().numpy()
        image = np.asarray(self.batch["image"])
        ref = self.batch.get("ref_image")
        out_dir = Path(trainer.save_dir) / "debug" / f"epoch_{epoch:04d}"
        for i in range(min(self.max_items, pred.shape[0])):
            panels = [image[i], pred[i]]
            if ref is not None:
                panels.append(np.asarray(ref)[i])
            write_image(out_dir / f"{i:03d}.jpg", np.concatenate(panels, axis=1))


@CALLBACKS.register(name="early_stop", aliases=["early_stopping"])
class EarlyStopHook:
    """Set ``trainer.max_epochs`` to the current epoch once the monitored
    metric has not improved by ``min_delta`` for ``patience`` epochs."""

    def __init__(self, monitor: str = "val/psnr", mode: str = "max", patience: int = 10,
                 min_delta: float = 1e-4):
        self.monitor = monitor
        self.sign = 1.0 if mode == "max" else -1.0
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.bad_epochs = 0

    def __call__(self, trainer, state, row):
        score = row.get(self.monitor)
        if score is None:
            return
        if self.best is None or self.sign * (score - self.best) > self.min_delta:
            self.best = score
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                trainer.max_epochs = row["epoch"]


@LOGGERS.register(name="tensorboard", aliases=["tensorboard_logger"])
@CALLBACKS.register(name="tensorboard")
class TensorBoardHook:
    """Every numeric row value as a scalar at the row's step; with
    ``image_batch``, the first enhanced image every
    ``image_every_n_epochs``. Writes ``log_dir`` (default
    ``save_dir/tb``)."""

    def __init__(self, log_dir=None, image_batch: dict | None = None,
                 image_every_n_epochs: int = 0, out_key: str = "enhanced"):
        self.log_dir = log_dir
        self.image_batch = image_batch
        self.image_every = image_every_n_epochs
        self.out_key = out_key
        self._writer = None

    def _get_writer(self, trainer):
        if self._writer is None:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(self.log_dir or str(trainer.save_dir) + "/tb")
        return self._writer

    def __call__(self, trainer, state, row):
        w = self._get_writer(trainer)
        step = row.get("step", row["epoch"])
        for k, v in row.items():
            if isinstance(v, (int, float)) and k not in ("epoch", "step"):
                w.add_scalar(k, v, step)
        if (self.image_batch is not None and self.image_every
                and row["epoch"] % self.image_every == 0):
            out = _forward(trainer, state.module, self.image_batch)[self.out_key]
            w.add_image(self.out_key, out[0].float().clamp(0, 1).cpu(), step,
                        dataformats="HWC")
        w.flush()


@CALLBACKS.register(name="progressive_training")
class ProgressiveTrainingHook:
    """Restormer's progressive patches: after each epoch, the DataModule's
    crop size and batch size for the next one from the schedule. The crop
    is one ``RandomCrop`` seeded with ``seed`` whose size changes, so its
    draws go on from epoch to epoch (the JAX package builds a new one with
    ``seed=None`` each epoch). Other transforms of the DataModule stay."""

    def __init__(self, datamodule, milestones, sizes, batch_sizes, seed: int | None = None):
        from enhax_torch.data.transforms import Compose, RandomCrop
        self.dm = datamodule
        self.milestones = tuple(milestones)
        self.sizes = tuple(sizes)
        self.batch_sizes = tuple(batch_sizes)
        self.crop = RandomCrop(self.sizes[0], seed=seed)
        existing = self.dm.transform
        if isinstance(existing, Compose):
            rest = [t for t in existing.transforms if not isinstance(t, RandomCrop)]
        elif existing is not None and not isinstance(existing, RandomCrop):
            rest = [existing]
        else:
            rest = []
        self.dm.transform = Compose([self.crop] + rest)
        if self.dm.train is not None:
            self.dm.train.transform = self.dm.transform
        self.apply_for_epoch(0)

    def apply_for_epoch(self, epoch: int) -> tuple:
        from enhax_torch.data.transforms import progressive_patch_schedule
        size, bs = progressive_patch_schedule(epoch, self.milestones, self.sizes,
                                              self.batch_sizes)
        self.dm.batch_size = bs
        self.crop.size = (size, size)
        return size, bs

    def __call__(self, trainer, state, row):
        self.apply_for_epoch(row["epoch"] + 1)


@CALLBACKS.register(name="stochastic_weight_averaging")
class SWAHook:
    """Stochastic weight averaging: from ``swa_epoch_start`` (a fraction of
    ``max_epochs``, or an epoch) on, the running mean of the parameters at
    every epoch end, in ``swa_module`` (a copy of the module; buffers are
    copied); checkpointed under ``swa`` when the trainer has a
    ``ckpt_dir``."""

    def __init__(self, swa_epoch_start: float | int = 0.8):
        self.swa_epoch_start = swa_epoch_start
        self.swa_module = None
        self.n_averaged = 0

    def _start_epoch(self, trainer) -> int:
        s = self.swa_epoch_start
        return int(s) if s >= 1 else int(s * trainer.max_epochs)

    @torch.no_grad()
    def __call__(self, trainer, state, row):
        if row["epoch"] < self._start_epoch(trainer):
            return
        if self.swa_module is None:
            self.swa_module = copy.deepcopy(state.module).requires_grad_(False)
            self.n_averaged = 1
        else:
            n = self.n_averaged
            for a, p in zip(self.swa_module.parameters(), state.module.parameters()):
                a.mul_(n).add_(p).div_(n + 1)
            for a, b in zip(self.swa_module.buffers(), state.module.buffers()):
                a.copy_(b)
            self.n_averaged += 1
        if trainer.ckpt_dir:
            from enhax_torch.train.checkpoints import save_checkpoint
            from enhax_torch.train.trainer import TrainState
            save_checkpoint(trainer.ckpt_dir,
                            TrainState(state.step, self.swa_module, state.optimizer),
                            row["epoch"], name="swa")


@CALLBACKS.register(name="learning_rate_monitor")
class LearningRateMonitorHook:
    """The lr into the row under ``key``: ``schedule`` at the state's step
    where one is given, else the lr the optimizer holds where no schedule
    writes it (the plateau scheduler's, JAX's injected hyperparameter)."""

    def __init__(self, schedule=None, key: str = "lr"):
        self.schedule = schedule
        self.key = key

    def __call__(self, trainer, state, row):
        if self.key in row:
            return
        if self.schedule is not None:
            row[self.key] = float(self.schedule(int(state.step)))
        elif getattr(trainer.tx, "schedule", True) is None:
            row[self.key] = float(state.optimizer.param_groups[0]["lr"])


@CALLBACKS.register(name="timer")
class TimerHook:
    """``elapsed_s`` since construction into every row; with ``duration``,
    stop once that many seconds have passed."""

    def __init__(self, duration: float | None = None):
        self.t0 = time.perf_counter()
        self.duration = duration

    def __call__(self, trainer, state, row):
        elapsed = time.perf_counter() - self.t0
        row["elapsed_s"] = round(elapsed, 3)
        if self.duration is not None and elapsed >= self.duration:
            trainer.max_epochs = row["epoch"]


@CALLBACKS.register(name="model_checkpoint")
class ModelCheckpointHook:
    """The reference's ``model_checkpoint`` callback by name: checkpointing
    is ``Trainer.fit``'s own (best on the monitor, and last); this sets the
    trainer's monitor (and directory) from a config at the first epoch's
    end."""

    def __init__(self, monitor: str = "val/psnr", mode: str = "max",
                 dirpath: str | None = None):
        self.monitor = monitor.split("/")[-1]
        self.mode = mode
        self.dirpath = dirpath
        self._applied = False

    def __call__(self, trainer, state, row):
        if self._applied:
            return
        trainer.monitor = (self.monitor, self.mode)
        if self.dirpath:
            trainer.ckpt_dir = self.dirpath
        self._applied = True


@LOGGERS.register(name="csv", aliases=["csv_logger", "log_training_progress"])
class CSVLogHook:
    """The epoch rows to another CSV file. The header is the first row's
    keys; a row with new keys rewrites the file with their union."""

    def __init__(self, path: str):
        self.path = path
        self._fieldnames: list | None = None

    def __call__(self, trainer, state, row):
        p = Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        flat = {k: v for k, v in row.items() if isinstance(v, (int, float, str))}
        if self._fieldnames is not None and any(k not in self._fieldnames for k in flat):
            with open(p, newline="") as fh:
                old_rows = list(csv.DictReader(fh))
            self._fieldnames += [k for k in flat if k not in self._fieldnames]
            rows, mode = old_rows + [flat], "w"
        else:
            rows, mode = [flat], "a"
        with open(p, mode, newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=self._fieldnames or list(flat), restval="",
                               extrasaction="ignore")
            if mode == "w" or self._fieldnames is None:
                w.writeheader()
            self._fieldnames = list(w.fieldnames)
            w.writerows(rows)
