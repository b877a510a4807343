"""Prediction CLI.

Port of ``enhax/cli/predict.py``: the source is a registered dataset name
(with ``--root``), a folder of images, an image or a video
(``data.io_worker.parse_io_worker``); a batched ``Predictor`` enhances each
item; images are written under ``--save-dir`` with the input's file name
(``--use-fullpath``: with its path below the data folder), a video's
frames into ``<save-dir>/video.mp4``. ``--config`` takes the train CLI's
config files (``model``, ``data``, ``model_cfg``); flags beat its values.

Usage:
    python -m enhax_torch.cli.predict --model zero_dce++_re --data ./images \
        --save-dir out [--weights params.npz | model.pth | run/ckpt/last] [--bf16]
    python -m enhax_torch.cli.predict --model hinet_re --data clip.mp4 --save-dir out
    python -m enhax_torch.cli.predict --config configs/nafnet_sidd.py --data sidd \
        --root ./data --save-dir out --benchmark
    python -m enhax_torch.cli.predict --model restormer --tile 384 --bf16 \
        --data ./rainy --save-dir out

``--weights`` takes the JAX package's flat ``.npz`` params (converted with
``enhax_torch.convert.from_jax``), a torch checkpoint (``.pt``/``.pth``/
``.ckpt``, nested releases unwrapped as the JAX CLI does:
``enhax_torch.convert.torch_weights``) or the port trainer's checkpoint
directory (``state.pt``; the EMA shadow where it has one, as the JAX CLI
prefers it). A JAX trainer's orbax directory is converted first with
``tools/jax_ckpt_to_torch.py``. ``--benchmark`` prints GFLOPs, params and
seconds an image of one 1x512x512 forward
(``nn.metrics.compute_efficiency_score``). ``--devices``/``--spatial``
(ROADMAP item 1.14) and ``zoo:`` weights (item 1.15h) are not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from enhax_torch.convert.torch_weights import CHECKPOINT_SUFFIXES, read_torch_checkpoint


def parse_predict_args(argv=None) -> dict:
    p = argparse.ArgumentParser("enhax-torch-predict")
    p.add_argument("--config", type=str, default=None,
                   help="a train config (model, data, model_cfg); flags beat its values")
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--data", type=str, default=None,
                   help="dataset name | image/folder path | video path")
    p.add_argument("--root", type=str, default=None, help="a dataset name's root folder")
    p.add_argument("--save-dir", type=str, default=None)
    p.add_argument("--weights", type=str, default=None,
                   help=".npz (JAX params), .pt/.pth/.ckpt (torch checkpoint) or a "
                        "trainer checkpoint directory")
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--resize", action="store_true")
    p.add_argument("--tile", type=int, default=None, help="tile size for tiled inference")
    p.add_argument("--tile-overlap", type=int, default=32)
    p.add_argument("--tile-blend", choices=["hann", "uniform"], default="hann",
                   help="hann = seam-free; uniform = the reference's unweighted "
                        "accumulation")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--buckets", type=int, nargs="*", default=None,
                   help="shape buckets, e.g. --buckets 256 512 1024 (pads up)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard inference over N devices (not ported yet)")
    p.add_argument("--spatial", action="store_true",
                   help="with --devices: split the image height too (not ported yet)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 inference (params + activations; outputs "
                        "cast back to float32)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when --weights is not given")
    p.add_argument("--benchmark", action="store_true",
                   help="print GFLOPs, params and seconds an image at 1x512x512")
    p.add_argument("--save-image", action="store_true", default=True)
    p.add_argument("--no-save-image", dest="save_image", action="store_false")
    p.add_argument("--save-debug", action="store_true",
                   help="also write the model's other image outputs under debug/")
    p.add_argument("--use-data-dir", action="store_true",
                   help="resolve a relative --data under $DATA_DIR")
    p.add_argument("--use-fullpath", action="store_true",
                   help="keep the source's subfolders under save-dir")
    p.add_argument("--verbose", action="store_true", help="print a line an item")
    p.add_argument("--device", type=str, default="cuda")
    return vars(p.parse_args(argv))


def load_weights(model, path: str) -> None:
    """Load ``.npz`` JAX params, a ``.pt``/``.pth``/``.ckpt`` checkpoint
    (``read_torch_checkpoint``: nestings unwrapped, prefixes stripped) or a
    port trainer checkpoint directory (its EMA shadow where it has one)
    into ``model``."""
    if path.startswith("zoo:"):
        raise NotImplementedError("zoo weights are not ported yet (ROADMAP item 1.15h)")
    p = Path(path)
    if p.is_dir():
        from enhax_torch.train.checkpoints import STATE_FILE
        if not (p / STATE_FILE).is_file():
            raise ValueError(f"{p} holds no {STATE_FILE}: a JAX trainer's orbax checkpoint is "
                             "converted first with tools/jax_ckpt_to_torch.py")
        payload = torch.load(p / STATE_FILE, map_location="cpu", weights_only=True)
        state = payload.get("ema") or payload["model"]
    elif p.suffix == ".npz":
        from enhax_torch.convert.from_jax import jax_to_torch_state_dict
        with np.load(p) as data:
            flat = {k: data[k] for k in data.files}
        state = jax_to_torch_state_dict(model.name, flat)
    elif p.suffix in CHECKPOINT_SUFFIXES:
        state = read_torch_checkpoint(p)
    else:
        raise ValueError(f"unsupported weights format: {p.suffix}")
    model.module.load_state_dict(state)


def _resolve(args: dict) -> tuple:
    """(model name, data, model_cfg) from the flags over ``--config``."""
    cfg = {}
    if args.get("config"):
        from enhax_torch.utils.config import load_config, parse_config_file
        path = parse_config_file(args["config"], search_dirs=["configs", "."])
        if path is None:
            raise SystemExit(f"config not found: {args['config']}")
        cfg = load_config(path)
    model_name = args.get("model") or cfg.get("model")
    data = args.get("data") or cfg.get("data")
    if not model_name or not data:
        raise SystemExit("--model and --data are required (or given via --config)")
    if args.get("use_data_dir") and not Path(data).exists() and not Path(data).is_absolute():
        from enhax_torch.constants import DATA_DIR
        data = str(DATA_DIR / data)
    return model_name, data, args.get("model_cfg") or cfg.get("model_cfg") or {}


def predict(args: dict) -> Path:
    from enhax_torch.data.io_worker import parse_io_worker
    from enhax_torch.infer import Predictor
    from enhax_torch.models.base import build_model
    from enhax_torch.ops.io import write_image

    if args.get("devices") or args.get("spatial"):
        raise NotImplementedError("--devices/--spatial: multi-device inference is not ported "
                                  "yet (ROADMAP item 1.14)")
    model_name, data, model_cfg = _resolve(args)
    model = build_model(model_name, device="cpu", seed=args.get("seed", 0), **model_cfg)
    if args.get("weights"):
        load_weights(model, args["weights"])
    imgsz = args.get("imgsz")
    tile = None
    if args.get("tile"):
        tile = (args["tile"], args["tile"], args.get("tile_overlap", 32))
    pred = Predictor(model, image_size=(imgsz, imgsz) if imgsz else None,
                     resize=bool(args.get("resize")), tile=tile,
                     tile_blend=args.get("tile_blend", "hann"),
                     bucket_sizes=tuple(args["buckets"]) if args.get("buckets") else None,
                     bf16=bool(args.get("bf16")), device=args.get("device", "cuda"))
    from enhax_torch.config.defaults import default_save_dir
    save_dir = Path(args.get("save_dir") or default_save_dir(
        "predict", model.arch, model.name, str(data).replace("/", "_")))

    if args.get("benchmark"):
        from enhax_torch.nn.metrics import compute_efficiency_score
        dp = {k: torch.zeros((1, 512, 512, 3 if k == "image" else 1), device=pred.device,
                             dtype=pred.model.dtype) for k in model.required_inputs}
        flops, params, avg_t = compute_efficiency_score(
            lambda d: pred.model.apply(d)[model.out_key], dp, model.param_count())
        print(f"[bench] FLOPs(G)={flops:.3f} Params(M)={params:.4f} t(s/img)={avg_t:.5f}")

    source, writer = parse_io_worker(data, dst=save_dir / "video.mp4", root=args.get("root"))
    items = ({k: v for k, v in item.items() if v is not None} for item in source)
    times, n = [], 0
    for outputs, metas in pred.predict_iter(items, args.get("batch_size", 1)):
        times.append(outputs["time"])
        enhanced = outputs[model.out_key].float().cpu().numpy()
        for i, (img, meta) in enumerate(zip(enhanced, metas)):
            name = meta.get("name", f"{n:06d}.png")
            if args.get("use_fullpath") and meta.get("path"):
                try:   # the source's subfolders below the data folder
                    rel = Path(meta["path"]).relative_to(Path(data).absolute())
                    name = str(rel.parent / f"{rel.stem}.png")
                except ValueError:
                    pass   # outside the data folder: the flat name
            if writer is not None:
                writer.write(img)
            elif args.get("save_image", True):
                write_image(save_dir / name, img)
            if args.get("save_debug"):
                for k, v in outputs.items():
                    if k != model.out_key and torch.is_tensor(v) and v.ndim == 4 \
                            and v.shape[-1] in (1, 3):
                        write_image(save_dir / "debug" / f"{Path(name).stem}_{k}.png",
                                    v[i].float().cpu().numpy())
            if args.get("verbose"):
                print(f"[predict] {name}: {outputs['time']:.4f}s")
            n += 1
    if writer is not None:
        writer.close()
    if times:
        print(f"[predict] {n} items -> {save_dir}; "
              f"avg time {np.mean(times[1:] if len(times) > 1 else times):.4f}s")
    return save_dir


def main(argv=None):
    predict(parse_predict_args(argv))


if __name__ == "__main__":
    main()
