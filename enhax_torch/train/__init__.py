"""Training of the port: the train and eval steps, the fit loop and
checkpoints."""

from enhax_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from enhax_torch.train.trainer import TrainState, Trainer, make_eval_step, make_train_step

__all__ = ["TrainState", "Trainer", "latest_checkpoint", "load_checkpoint", "make_eval_step",
           "make_train_step", "save_checkpoint"]
