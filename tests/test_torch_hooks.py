"""Port parity: the trainer hooks (``enhax_torch/train/hooks.py``) against the
JAX package's, on the CPU.

The cases of ``tests/test_hooks.py`` on the port (debug images, early stop,
TensorBoard, the progressive schedule, SWA), and each hook beside the JAX
package's where both can see the same rows: the learning-rate monitor under
the plateau scheduler, the timer, the model-checkpoint hook, the CSV
logger; the registries' names and aliases; ``Trainer``'s hooks, its
plateau step and ``log_image_every_n_epochs``.
"""

import csv
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

from enhax.constants import CALLBACKS as JAX_CALLBACKS
from enhax.constants import LOGGERS as JAX_LOGGERS
from enhax.train import hooks as jhooks
from enhax_torch.constants import CALLBACKS, LOGGERS
from enhax_torch.models.base import build_model
from enhax_torch.train import (CSVLogHook, DebugImageHook, EarlyStopHook,
                               LearningRateMonitorHook, ModelCheckpointHook,
                               ProgressiveTrainingHook, SWAHook, TensorBoardHook, TimerHook,
                               Trainer)
from enhax_torch.train.checkpoints import load_checkpoint
from torch_threads import capped_torch_threads  # noqa: F401

OPT = {"optimizer": {"name": "adam", "lr": 1e-3}}


@pytest.fixture
def batch(rng):
    return {"image": rng.uniform(0, 0.3, (2, 16, 16, 3)).astype(np.float32),
            "ref_image": rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)}


def tiny():
    return build_model("zero_dce_re", device="cpu", num_channels=8)


def _trainer(tmp_path, hooks, epochs=3, **kw):
    return Trainer(tiny(), OPT, max_epochs=epochs, save_dir=tmp_path,
                   log_every_n_steps=1000, hooks=hooks, **kw)


def test_registries_hold_the_jax_names():
    assert sorted(CALLBACKS) == sorted(JAX_CALLBACKS)
    assert sorted(LOGGERS) == sorted(JAX_LOGGERS)
    for reg, jreg in ((CALLBACKS, JAX_CALLBACKS), (LOGGERS, JAX_LOGGERS)):
        assert reg._aliases == jreg._aliases
        assert {k: v.__name__ for k, v in reg.items()} == {
            k: v.__name__ for k, v in jreg.items()}


def test_debug_image_hook(batch, tmp_path):
    tr = _trainer(tmp_path, [DebugImageHook(batch, every_n_epochs=1)])
    tr.fit(lambda: [batch])
    dumps = glob.glob(str(tmp_path / "debug" / "epoch_*" / "*.jpg"))
    assert len(dumps) == 6  # 3 epochs x 2 items
    import cv2
    img = cv2.imread(dumps[0])
    assert img.shape == (16, 48, 3)   # input | output | ref


def test_early_stop_hook(batch, tmp_path):
    hook = EarlyStopHook(monitor="val/psnr", patience=1, min_delta=100.0)
    tr = _trainer(tmp_path, [hook], epochs=20)
    tr.fit(lambda: [batch], val_iter_fn=lambda: [batch])
    assert tr.max_epochs < 20 and len(tr.history) <= 3


def test_early_stop_matches_jax_on_a_row_sequence():
    """Both hooks over the same rows lower max_epochs at the same epoch."""
    rows = [{"epoch": e, "val/psnr": p} for e, p in enumerate([20, 21, 21.05, 21.5, 21.5, 21.55])]

    class T:
        max_epochs = 100

    got, want = T(), T()
    port = EarlyStopHook(patience=2, min_delta=0.1)
    ref = jhooks.EarlyStopHook(patience=2, min_delta=0.1)
    for r in rows:
        port(got, None, dict(r))
        ref(want, None, dict(r))
        assert got.max_epochs == want.max_epochs
    assert got.max_epochs == 5


@pytest.mark.skipif(importlib.util.find_spec("tensorboard") is None,
                    reason="the tensorboard package is not installed")
def test_tensorboard_hook(batch, tmp_path):
    tr = _trainer(tmp_path, [TensorBoardHook(image_batch=batch, image_every_n_epochs=1)])
    tr.fit(lambda: [batch], val_iter_fn=lambda: [batch])
    events = glob.glob(str(tmp_path / "tb" / "events.*"))
    assert events and sum(os.path.getsize(e) for e in events) > 100


def test_progressive_hook_matches_jax(tmp_path):
    """The JAX case (crop 16 then 32, batch 4 then 1) against the JAX hook on
    a DataModule of each package: the same (size, batch) each epoch, and the
    items cropped to it; other transforms stay."""
    import cv2

    from enhax.constants import DATAMODULES as JAX_DATAMODULES
    from enhax_torch.constants import DATAMODULES
    from enhax_torch.data import Compose, RandomFlip
    d = tmp_path / "lol_v1" / "train" / "image"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(d / f"{i}.png"), (rng.uniform(0, 1, (40, 40, 3)) * 255).astype(np.uint8))
    sched = {"milestones": (0, 1, 3), "sizes": (16, 32, 24), "batch_sizes": (4, 1, 2)}
    dm = DATAMODULES.build("lol_v1", root=tmp_path, batch_size=4)
    dm.setup("train")
    flip = RandomFlip(seed=0)
    dm.transform = Compose([flip])
    jdm = JAX_DATAMODULES.build("lol_v1", root=tmp_path, batch_size=4)
    jdm.setup("train")
    hook = ProgressiveTrainingHook(dm, **sched, seed=0)
    jhook = jhooks.ProgressiveTrainingHook(jdm, **sched)
    assert dm.batch_size == jdm.batch_size == 4
    for epoch in range(5):
        size, bs = hook.apply_for_epoch(epoch)
        assert (size, bs) == jhook.apply_for_epoch(epoch)
        assert dm.batch_size == bs
        assert dm.train[0]["image"].shape[:2] == jdm.train[0]["image"].shape[:2] == (size, size)
    assert flip in dm.transform.transforms


def test_swa_hook(batch, tmp_path):
    """SWA from epoch 2 of 4 averages two epochs' parameters, checkpointed
    as ``swa``: the mean of the module after epochs 2 and 3."""
    snaps = []

    def snap(trainer, state, row):
        snaps.append({k: v.clone() for k, v in state.module.state_dict().items()})

    hook = SWAHook(swa_epoch_start=0.5)
    tr = _trainer(tmp_path, [snap, hook], epochs=4, ckpt_dir=tmp_path / "ckpt")
    state = tr.fit(lambda: [batch], resume=False)
    assert hook.n_averaged == 2 and hook.swa_module is not None
    for k, v in hook.swa_module.state_dict().items():
        torch.testing.assert_close(v, (snaps[2][k] + snaps[3][k]) / 2, rtol=0, atol=1e-7)
    restored, _ = load_checkpoint(tmp_path / "ckpt" / "swa", Trainer(tiny(), OPT).init_state())
    for k, v in restored.module.state_dict().items():
        assert torch.equal(v, hook.swa_module.state_dict()[k])
    assert state.step == 4


def test_learning_rate_monitor_and_plateau_match_jax(batch, tmp_path):
    """The plateau scheduler on ``val/psnr`` (max, patience 0): each epoch
    ``row["lr"]`` is what the JAX package's plateau object gives for the
    same metric sequence, and the optimizer holds it; the monitor hook
    records the same lr; with a schedule it records the schedule's lr at
    the state's step."""
    from enhax.nn.optim import ReduceLROnPlateau as JaxPlateau
    cfg = {"optimizer": {"name": "adam", "lr": 1e-2},
           "lr_scheduler": {"scheduler": {"name": "reduce_lr_on_plateau", "mode": "max",
                                          "patience": 0, "factor": 0.5,
                                          "monitor": "val/psnr"}}}
    lrm = LearningRateMonitorHook(key="lr_seen")
    tr = Trainer(tiny(), cfg, max_epochs=4, log_every_n_steps=1000, hooks=[lrm])
    state = tr.fit(lambda: [batch], val_iter_fn=lambda: [batch], resume=False)
    ref = JaxPlateau(1e-2, mode="max", patience=0, factor=0.5)
    for row in tr.history:
        assert row["lr"] == ref.step(row["val/psnr"]) == row["lr_seen"]
    assert state.optimizer.param_groups[0]["lr"] == tr.history[-1]["lr"]
    assert len({row["lr"] for row in tr.history}) > 1
    sched = lambda step: 1e-3 * (step + 1)  # noqa: E731
    row = {"epoch": 0}
    LearningRateMonitorHook(schedule=sched)(tr, state, row)
    want = {"epoch": 0}
    jhooks.LearningRateMonitorHook(schedule=sched)(None, state, want)
    assert row == want == {"epoch": 0, "lr": 1e-3 * 5}


def test_timer_and_model_checkpoint_hooks(batch, tmp_path):
    """The timer records ``elapsed_s`` into each row (and, spent, stops the
    run); the checkpoint hook points the trainer's monitor and directory,
    as the JAX hooks do."""
    timer = TimerHook(duration=0.0)
    mc = ModelCheckpointHook(monitor="val/loss", mode="min", dirpath=str(tmp_path / "mc"))
    tr = _trainer(tmp_path, [timer, mc], epochs=5, ckpt_dir=tmp_path / "ckpt")
    tr.fit(lambda: [batch], val_iter_fn=lambda: [batch], resume=False)
    assert len(tr.history) == 1 and tr.history[0]["elapsed_s"] >= 0
    assert tr.monitor == ("loss", "min") and tr.ckpt_dir == str(tmp_path / "mc")
    assert (tmp_path / "mc" / "best" / "state.pt").is_file()

    class T:
        monitor, ckpt_dir = ("psnr", "max"), None

    jt = T()
    jhooks.ModelCheckpointHook(monitor="val/loss", mode="min", dirpath=str(tmp_path / "mc"))(
        jt, None, {})
    assert (jt.monitor, jt.ckpt_dir) == (tr.monitor, tr.ckpt_dir)


def test_csv_log_hook_writes_what_jax_writes(tmp_path):
    """Rows gaining keys (val/* later, lr after a plateau step) rewrite the
    file with the union of the keys; the port's file equals the JAX hook's."""
    rows = [{"epoch": 0, "step": 3, "train/loss": 0.5},
            {"epoch": 1, "step": 6, "train/loss": 0.4, "val/psnr": 21.0, "meta": [1]},
            {"epoch": 2, "step": 9, "train/loss": 0.3, "val/psnr": 22.0, "lr": 1e-4}]
    port, ref = CSVLogHook(str(tmp_path / "a" / "log.csv")), jhooks.CSVLogHook(
        str(tmp_path / "b" / "log.csv"))
    for r in rows:
        port(None, None, dict(r))
        ref(None, None, dict(r))
    got = list(csv.reader(open(tmp_path / "a" / "log.csv")))
    assert got == list(csv.reader(open(tmp_path / "b" / "log.csv")))
    assert got[0] == ["epoch", "step", "train/loss", "val/psnr", "lr"] and len(got) == 4


def test_trainer_calls_hooks_after_the_csv_write(batch, tmp_path):
    """Each hook sees the epoch's row after log.csv holds it; a key a hook
    adds reaches the next write; ``log_image_every_n_epochs`` is stored."""
    seen = []

    def hook(trainer, state, row):
        lines = open(tmp_path / "log.csv").read().splitlines()
        seen.append((row["epoch"], len(lines) - 1, state.step))
        row["hook/epoch"] = row["epoch"]

    tr = _trainer(tmp_path, [hook], epochs=2, log_image_every_n_epochs=1)
    tr.fit(lambda: [batch, batch], resume=False)
    assert seen == [(0, 1, 2), (1, 2, 4)]
    assert tr.log_image_every_n_epochs == 1
    assert [r["hook/epoch"] for r in csv.DictReader(open(tmp_path / "log.csv"))][0] == "0"
