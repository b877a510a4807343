"""Training of the port: the train and eval steps, the fit loop, its hooks
and checkpoints. Importing this package registers the hooks in
``CALLBACKS`` and ``LOGGERS``."""

from enhax_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from enhax_torch.train.hooks import (CSVLogHook, DebugImageHook, EarlyStopHook,
                                     LearningRateMonitorHook, ModelCheckpointHook,
                                     ProgressiveTrainingHook, SWAHook, TensorBoardHook,
                                     TimerHook)
from enhax_torch.train.trainer import TrainState, Trainer, make_eval_step, make_train_step

__all__ = ["CSVLogHook", "DebugImageHook", "EarlyStopHook", "LearningRateMonitorHook",
           "ModelCheckpointHook", "ProgressiveTrainingHook", "SWAHook", "TensorBoardHook",
           "TimerHook", "TrainState", "Trainer", "latest_checkpoint", "load_checkpoint",
           "make_eval_step", "make_train_step", "save_checkpoint"]
