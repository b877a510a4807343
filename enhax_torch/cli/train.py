"""Training CLI.

Port of ``enhax/cli/train.py``: resolve the config (a ``.py`` module or
flags; flags win), build the datamodule and the model from the registries,
resume from the newest checkpoint under ``<save-dir>/ckpt``, fit.

Usage:
    python -m enhax_torch.cli.train --config configs/nafnet_sidd.py \
        --root /data --steps 1000 [--device cuda] [--bf16] [--save-dir run/x]

``--root`` holds the dataset's tree: ``<data>/{train,test}/image`` and
``<data>/{train,test}/ref`` (degraded and clean images of the same names),
e.g. ``sidd/...`` for ``configs/nafnet_sidd.py``, ``gopro/...`` for
``configs/hinet_gopro.py``, ``sice_mix/...`` for the Zero-DCE configs.
With the environment variable ``ENHAX_FUSED_TRAIN=1``, as for the JAX CLI,
the training forward runs the model's fused path where it has one that
trains (NAFNet's K1/K2 kernels on the card); any other model trains its
module. The crops of
``--image-size`` (or the config's ``image_size``) are drawn from a numpy
generator seeded with ``--seed``; the weights from one seeded with the
trainer config's ``seed``.

Not ported yet: ``--strategy`` and ``--devices`` (ROADMAP item 1.14);
``--weights``, the progressive patch schedule and trainer callbacks (item
1.12). Each raises.
"""

from __future__ import annotations

import argparse
import os

from enhax_torch.config.defaults import (DEFAULT_DATAMODULE, DEFAULT_OPTIMIZER,
                                         DEFAULT_TRAINER, default_save_dir)
from enhax_torch.utils.config import load_config, merge_configs, parse_config_file


def parse_train_args(argv=None) -> dict:
    p = argparse.ArgumentParser("enhax-torch-train")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--root", type=str, default=None, help="dataset root dir")
    p.add_argument("--project", type=str, default=None)
    p.add_argument("--fullname", type=str, default=None)
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--strategy", type=str, default=None)
    p.add_argument("--precision", type=str, default=None, help="bf16-mixed | bf16 | 32")
    p.add_argument("--bf16", action="store_true", help="shorthand for --precision bf16-mixed")
    p.add_argument("--devices", type=int, default=None)
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = vars(p.parse_args(argv))
    cfg = {}
    path = parse_config_file(args.pop("config"), search_dirs=["config", "."]) \
        if args.get("config") else None
    if path:
        cfg = load_config(path)
    return merge_configs(cfg, {k: v for k, v in args.items() if v is not None})


def train(args: dict):
    from enhax_torch.constants import DATAMODULES
    from enhax_torch.data import Compose, RandomCrop  # also registers the datasets
    from enhax_torch.models.base import build_model
    from enhax_torch.train import Trainer

    model_name = args.get("model") or args.get("model_name")
    data_name = args.get("data") or args.get("data_name")
    if not model_name or not data_name:
        raise SystemExit("--model and --data are required (or given via --config)")
    for flag, item in (("strategy", "1.14"), ("devices", "1.14"), ("weights", "1.12"),
                       ("progressive", "1.12")):
        if args.get(flag):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP item {item})")

    tr_cfg = merge_configs(DEFAULT_TRAINER, args.get("trainer_cfg") or {})
    if tr_cfg.get("callbacks"):
        raise NotImplementedError("trainer callbacks are not ported yet (ROADMAP item 1.12)")
    model_cfg = dict(args.get("model_cfg") or args.get("model_kwargs") or {})
    model = build_model(model_name, device=args.get("device", "cuda"), seed=tr_cfg["seed"],
                        **model_cfg)

    dm_cfg = merge_configs(DEFAULT_DATAMODULE, args.get("data_cfg") or {})
    if args.get("batch_size"):
        dm_cfg["batch_size"] = args["batch_size"]
    dm = DATAMODULES.build(data_name, root=args.get("root"), **dm_cfg)
    dm.setup()
    dm.summarize()
    if args.get("image_size"):
        dm.transform = Compose([RandomCrop(args["image_size"], seed=args.get("seed", 0))])
        if dm.train is not None:
            dm.train.transform = dm.transform

    opt_cfg = merge_configs(DEFAULT_OPTIMIZER, args.get("optimizer_cfg") or {})
    if args.get("lr"):
        opt_cfg["optimizer"]["lr"] = args["lr"]
    save_dir = args.get("save_dir") or default_save_dir("train", model.arch, model.name,
                                                        data_name)
    if args.get("epochs"):
        tr_cfg["max_epochs"] = args["epochs"]
    if args.get("steps"):
        tr_cfg["max_steps"] = args["steps"]
    if args.get("bf16"):
        tr_cfg["precision"] = "bf16-mixed"
    elif args.get("precision"):
        tr_cfg["precision"] = args["precision"]

    # as the JAX package, a model without a fused training path trains its
    # module under ENHAX_FUSED_TRAIN=1
    fused_train = os.environ.get("ENHAX_FUSED_TRAIN", "0") == "1"
    if fused_train and not model.trains_fused:
        print(f"[train] ENHAX_FUSED_TRAIN=1: {model.name} has no fused training path; "
              "training its module")
        fused_train = False
    trainer = Trainer(
        model, opt_cfg,
        max_epochs=tr_cfg["max_epochs"], max_steps=tr_cfg.get("max_steps"),
        ckpt_dir=str(save_dir) + "/ckpt", monitor=tr_cfg["monitor"],
        log_every_n_steps=tr_cfg["log_every_n_steps"], save_dir=save_dir,
        remat=bool(tr_cfg.get("remat", False)),
        gradient_clip_val=tr_cfg.get("gradient_clip_val"),
        gradient_clip_algorithm=tr_cfg.get("gradient_clip_algorithm", "norm"),
        accumulate_grad_batches=int(tr_cfg.get("accumulate_grad_batches", 1) or 1),
        limit_train_batches=tr_cfg.get("limit_train_batches"),
        limit_val_batches=tr_cfg.get("limit_val_batches"),
        overfit_batches=int(tr_cfg.get("overfit_batches", 0) or 0),
        fast_dev_run=bool(tr_cfg.get("fast_dev_run", False)),
        precision=tr_cfg.get("precision"),
        ema_decay=tr_cfg.get("ema_decay"),
        fused_train=fused_train,
    )
    print(f"[train] {model.name} on {data_name} -> {save_dir}")
    val_fn = dm.val_loader if dm.val is not None else None
    state = trainer.fit(dm.train_loader, val_fn)
    print(f"[train] done at step {state.step}")
    return state


def main(argv=None):
    return train(parse_train_args(argv))


if __name__ == "__main__":
    main()
