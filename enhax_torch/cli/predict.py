"""Prediction CLI.

Port of ``enhax/cli/predict.py`` for an image or a folder of images:
batched ``Predictor``, one enhanced image per input under ``--save-dir``,
under the input's file name.

Usage:
    python -m enhax_torch.cli.predict --model zero_dce++_re --data ./images \
        --save-dir out [--weights params.npz | model.pth] [--bf16] [--device cuda]
    python -m enhax_torch.cli.predict --model nafnet_local --bf16 --data ./noisy \
        --save-dir out --weights NAFNet-SIDD-width32.pth
    python -m enhax_torch.cli.predict --model restormer --tile 384 --bf16 \
        --data ./rainy --save-dir out

``--weights`` takes the JAX package's flat ``.npz`` params (converted with
``enhax_torch.convert.from_jax``) or a torch checkpoint (``.pt``/``.pth``/
``.ckpt``, nested releases unwrapped as the JAX CLI does:
``enhax_torch.convert.torch_weights``).
Dataset names, videos, ``zoo:`` weights and orbax checkpoint directories
are not ported yet (ROADMAP slice 1, item 6).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from enhax_torch.convert.torch_weights import CHECKPOINT_SUFFIXES, read_torch_checkpoint

IMAGE_EXTS = (".bmp", ".jpg", ".jpeg", ".png", ".ppm", ".tif", ".tiff", ".webp")
_NOT_PORTED = "is not ported yet (ROADMAP slice 1, item 6)"


def parse_predict_args(argv=None) -> dict:
    p = argparse.ArgumentParser("enhax-torch-predict")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--data", type=str, required=True,
                   help="an image or a folder of images")
    p.add_argument("--save-dir", type=str, required=True)
    p.add_argument("--weights", type=str, default=None,
                   help=".npz (JAX params) or .pt/.pth/.ckpt (torch checkpoint)")
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
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 inference (params + activations; outputs "
                        "cast back to float32)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when --weights is not given")
    p.add_argument("--device", type=str, default="cuda")
    return vars(p.parse_args(argv))


def _image_files(data: str) -> list[Path]:
    path = Path(data)
    if path.is_dir():
        return sorted(f for f in path.rglob("*")
                      if f.is_file() and f.suffix.lower() in IMAGE_EXTS)
    if path.is_file() and path.suffix.lower() in IMAGE_EXTS:
        return [path]
    raise NotImplementedError(f"data source {data!r}: only an image or a folder of "
                              f"images is supported; dataset names and video "
                              f"{_NOT_PORTED}")


def load_weights(model, path: str) -> None:
    """Load ``.npz`` JAX params or a ``.pt``/``.pth``/``.ckpt`` checkpoint
    (``read_torch_checkpoint``: nestings unwrapped, prefixes stripped) into
    ``model``."""
    if path.startswith("zoo:"):
        raise NotImplementedError(f"zoo weights {_NOT_PORTED}")
    p = Path(path)
    if p.is_dir():
        raise NotImplementedError(f"orbax checkpoint directories {_NOT_PORTED}")
    if p.suffix == ".npz":
        from enhax_torch.convert.from_jax import jax_to_torch_state_dict
        with np.load(p) as data:
            flat = {k: data[k] for k in data.files}
        state = jax_to_torch_state_dict(model.name, flat)
    elif p.suffix in CHECKPOINT_SUFFIXES:
        state = read_torch_checkpoint(p)
    else:
        raise ValueError(f"unsupported weights format: {p.suffix}")
    model.module.load_state_dict(state)


def predict(args: dict) -> Path:
    from enhax_torch.infer import Predictor
    from enhax_torch.models.base import build_model
    from enhax_torch.ops.io import read_image, write_image

    files = _image_files(args["data"])
    model = build_model(args["model"], device="cpu", seed=args.get("seed", 0))
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
    save_dir = Path(args["save_dir"])
    items = ({"image": read_image(f), "meta": {"name": f.name}} for f in files)
    times = []
    for outputs, metas in pred.predict_iter(items, args.get("batch_size", 1)):
        times.append(outputs["time"])
        enhanced = outputs[model.out_key].float().cpu().numpy()
        for img, meta in zip(enhanced, metas):
            write_image(save_dir / meta["name"], img)
    if times:
        print(f"[predict] {len(files)} items -> {save_dir}; "
              f"avg time {np.mean(times[1:] if len(times) > 1 else times):.4f}s")
    return save_dir


def main(argv=None):
    predict(parse_predict_args(argv))


if __name__ == "__main__":
    main()
