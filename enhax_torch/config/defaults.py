"""Default config dicts of the train CLI.

Port of ``enhax/config/defaults.py``: the trainer, datamodule and optimizer
defaults the CLI merges a config and its flags over, and the run directory
layout.
"""

from __future__ import annotations

from enhax_torch.constants import RUN_DIR

DEFAULT_TRAINER = {
    "max_epochs": 100,
    "max_steps": None,
    "monitor": ("psnr", "max"),
    "log_every_n_steps": 50,
    "log_image_every_n_epochs": 0,
    "seed": 0,
    "gradient_clip_val": None,
    "gradient_clip_algorithm": "norm",
    "accumulate_grad_batches": 1,
    "limit_train_batches": None,
    "limit_val_batches": None,
    "overfit_batches": 0,
    "fast_dev_run": False,
}

DEFAULT_DATAMODULE = {
    "batch_size": 8,
    "shuffle": True,
    "drop_last": False,
    # a thread pool decodes the samples of a batch (cv2 drops the GIL)
    "num_workers": 4,
}

DEFAULT_OPTIMIZER = {
    "optimizer": {"name": "adam", "lr": 1e-4, "betas": (0.9, 0.999)},
    "grad_clip_norm": None,
}


def default_save_dir(mode: str, arch: str, model: str, data: str):
    """run/{train,predict}/{arch}/{model}/{data}."""
    return RUN_DIR / mode / arch / model / data
