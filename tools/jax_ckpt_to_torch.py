"""Convert a JAX trainer checkpoint (an orbax directory) into the PyTorch
port's ``state.pt``, so that a run started with the JAX package resumes in
the port (``enhax_torch.cli.train``) or serves from it (the port's predict
CLI takes the directory as ``--weights``).

    python tools/jax_ckpt_to_torch.py <orbax dir> <out dir> --model NAME \
        [--config configs/nafnet_sidd.py] [--model-cfg JSON] \
        [--optimizer-cfg JSON] [--trainer-cfg JSON]

The checkpoint is restored with the JAX package's ``load_checkpoint`` into
the structure the JAX trainer builds from the same configuration (model,
optimizer, clip, ``accumulate_grad_batches``, EMA), then bridged by
``enhax_torch.convert.from_jax.jax_checkpoint_to_torch`` and written as
``<out dir>/state.pt``. The JSON flags beat the config file's values. This
tool runs where JAX and orbax are installed; the port never imports them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def convert(src, dst, model: str, config: str | None = None, model_cfg: dict | None = None,
            optimizer_cfg: dict | None = None, trainer_cfg: dict | None = None) -> Path:
    """Restore ``src`` with the JAX package and write the port's payload to
    ``dst/state.pt``; returns its path."""
    import jax
    import numpy as np
    import torch

    from enhax.config.defaults import DEFAULT_OPTIMIZER, DEFAULT_TRAINER
    from enhax.constants import MODELS
    from enhax.train import Trainer
    from enhax.train.checkpoints import load_checkpoint
    from enhax.utils.config import load_config, merge_configs
    from enhax_torch.convert.from_jax import jax_checkpoint_to_torch
    from enhax_torch.train.checkpoints import STATE_FILE

    cfg = load_config(config) if config else {}
    model_cfg = {**(cfg.get("model_cfg") or {}), **(model_cfg or {})}
    opt_cfg = merge_configs(DEFAULT_OPTIMIZER, {**(cfg.get("optimizer_cfg") or {}),
                                                **(optimizer_cfg or {})})
    tr_cfg = merge_configs(DEFAULT_TRAINER, {**(cfg.get("trainer_cfg") or {}),
                                             **(trainer_cfg or {})})
    jm = MODELS.build(model, **model_cfg)
    trainer = Trainer(jm, opt_cfg, gradient_clip_val=tr_cfg.get("gradient_clip_val"),
                      gradient_clip_algorithm=tr_cfg.get("gradient_clip_algorithm", "norm"),
                      accumulate_grad_batches=int(tr_cfg.get("accumulate_grad_batches") or 1),
                      ema_decay=tr_cfg.get("ema_decay"))
    # an example the size of the divisor: a window model's params depend on it
    hw = max(64, jm.size_divisor or 1)
    example = {k: np.zeros((1, hw, hw, 3 if k == "image" else 1), np.float32)
               for k in jm.required_inputs}
    # the structure to restore into: the trainer's state around a jitted init
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), example)
    state, epoch = load_checkpoint(src, trainer.init_state(example, params=params))
    payload = jax_checkpoint_to_torch(
        model, {"step": state.step, "epoch": epoch - 1, "params": state.params,
                "opt_state": state.opt_state, "ema": state.ema},
        opt_cfg, tr_cfg, model_cfg)
    out = Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(payload, out / STATE_FILE)
    return out / STATE_FILE


def main(argv=None) -> None:
    p = argparse.ArgumentParser("jax-ckpt-to-torch")
    p.add_argument("src", help="the JAX trainer's checkpoint directory (e.g. ckpt/last)")
    p.add_argument("dst", help="the port's checkpoint directory to write state.pt into")
    p.add_argument("--model", required=True)
    p.add_argument("--config", default=None)
    for flag in ("--model-cfg", "--optimizer-cfg", "--trainer-cfg"):
        p.add_argument(flag, type=json.loads, default=None)
    a = p.parse_args(argv)
    path = convert(a.src, a.dst, a.model, a.config, a.model_cfg, a.optimizer_cfg, a.trainer_cfg)
    print(f"[jax_ckpt_to_torch] {a.src} -> {path}")


if __name__ == "__main__":
    main()
