"""The end-to-end quality chains in the port: train -> predict CLI -> metric CLI.

Port of ``run/make_quality.py``, the repo's acceptance record: the
committed golden set (``assets/golden``: four 64x64 gamma-darkened scenes
and their references) is enhanced by small models trained at a fixed seed
through the port's ``Trainer``; the port's predict CLI writes their output
and the port's metric CLI scores it (PSNR and SSIM, and PSNR after GT-mean
scaling). Besides the five trained chains, ``EXTRA_CHAINS`` run the
predictor's other paths through the same CLIs: two instance fits, HINet
overlap-tiled from ``hinet_tiny``'s checkpoint, and an 8-frame video
through the predict CLI's video source and ``video.mp4`` writer.

    python -m enhax_torch.quality --device cpu|cuda --out rows.json

The rows (the nine of ``QUALITY.json``, under its keys) go to ``--out`` as
JSON; ``QUALITY.json`` itself is the JAX package's record and is never
written here. ``tests/test_quality_artifact.py`` states the bars a row
meets. Every chain starts from the JAX package's own init, ``model.init(
PRNGKey(0), ...)`` as its trainer and Predictor draw it, drawn without JAX
by ``convert.jax_init``. The record's bars were set on that init, and the
JAX package's own chains from other keys miss them as often as the port's
seeded init does (``tools/quality_spread.py``: ``uformer_tiny`` reaches
SSIM 0.3858-0.4133 from keys 1-4 of the JAX package and 0.3905-0.422 from
seeds 0-3 of the port, against the floor of 0.46; ``zero_mie_ms_instance``
stays under its input's PSNR + 0.3 dB from keys 1 and 2 of the JAX package
and seeds 0-2 of the port). Everything runs on ``device``: CUDA unless
asked otherwise.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "assets" / "golden"

# (name, model, model_cfg, supervised, epochs, lr): run/make_quality.py's
MODELS_UNDER_TEST = [
    ("zero_dce_re", "zero_dce_re", {"num_channels": 16}, False, 60, 1e-3),
    ("hinet_tiny", "hinet_re", {"num_channels": 8, "depth": 2, "in_pos_right": 1}, True, 60,
     2e-3),
    ("nafnet_tiny", "nafnet", {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1),
                               "dec_blk_nums": (1, 1)}, True, 60, 2e-3),
    ("restormer_tiny", "restormer", {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1,
                                     "heads": (1, 1, 2, 2)}, True, 60, 2e-3),
    # window attention at size_divisor 128: trains on 2x2 mosaics of the
    # golden scenes; lr 5e-4 as the JAX record's
    ("uformer_tiny", "uformer_re", {"dim": 16, "depths": (1, 1, 1, 1, 1, 1, 1, 1, 1)}, True,
     120, 5e-4),
]

# the instance and tiled predict chains (no training), as run/make_quality.py's
EXTRA_CHAINS = [
    ("colie_instance", {"model": "colie_re", "model_cfg": {}, "seed": 0}),
    ("hinet_tiny_tiled", {"model": "hinet_re",
                          "model_cfg": {"num_channels": 8, "depth": 2, "in_pos_right": 1},
                          "tile": 32, "tile_overlap": 8, "tile_blend": "uniform", "seed": 0,
                          "_reuse_ckpt": "hinet_tiny", "_delta_vs": "hinet_tiny"}),
    ("zero_mie_ms_instance", {"model": "zero_mie_ms",
                              "model_cfg": {"hidden_channels": 32, "down_size": 32,
                                            "window_size": [3, 5]},
                              "seed": 0}),
]

def golden(kind: str) -> np.ndarray:
    """The four golden images (``image``) or references (``ref``), (4, 64, 64, 3)."""
    from enhax_torch.ops.io import read_image
    return np.stack([read_image(GOLDEN / kind / f"{i:02d}.png") for i in range(4)]).astype(
        np.float32)


def training_batch(supervised: bool, div: int) -> dict:
    """The golden batch as ``run_one`` trains on it: where the model's size
    divisor is a multiple of 64, each sample is a k x k cyclic mosaic of the
    scenes (every pixel real content), else reflect-padded up to it."""
    batch = {"image": golden("image")}
    if supervised:
        batch["ref_image"] = golden("ref")
    h, n = batch["image"].shape[1], batch["image"].shape[0]
    if h % div and div % h == 0:
        k = div // h

        def mosaic(v, s):
            rows = [np.concatenate([v[(s + k * r + c) % n] for c in range(k)], axis=1)
                    for r in range(k)]
            return np.concatenate(rows, axis=0)

        return {key: np.stack([mosaic(v, s) for s in range(n)]) for key, v in batch.items()}
    if h % div:
        pad = div - h % div
        return {key: np.pad(v, ((0, 0), (0, pad), (0, pad), (0, 0)), mode="reflect")
                for key, v in batch.items()}
    return batch


def chain_scores(pred_dir, target, device: str) -> dict:
    """The metric CLI's PSNR and SSIM of ``pred_dir`` against ``target``, its
    GT-mean PSNR, and the input's scores (the golden images')."""
    from enhax_torch.cli.metric import measure_metric
    scores = measure_metric({"input": str(pred_dir), "target": str(target),
                             "metric": ["psnr", "ssim"], "device": device})
    gt_mean = measure_metric({"input": str(pred_dir), "target": str(target),
                              "metric": ["psnr"], "use_gt_mean": True, "device": device})
    base = measure_metric({"input": str(GOLDEN / "image"),
                           "target": str(GOLDEN / "ref"), "metric": ["psnr", "ssim"],
                           "device": device})
    return {"psnr": round(float(scores["psnr"]), 3), "ssim": round(float(scores["ssim"]), 4),
            "psnr_gt_mean": round(float(gt_mean["psnr"]), 3),
            "input_psnr": round(float(base["psnr"]), 3),
            "input_ssim": round(float(base["ssim"]), 4)}


def run_one(name, model_name, model_cfg, supervised, epochs, lr, out_root, device="cuda",
            init=None, history=None) -> dict:
    """Train ``model_name`` on the golden batch for ``epochs`` one-batch
    epochs (Adam at ``lr``; the gradient norm clipped to 0.1 for the
    unsupervised chain) from ``init`` (default: the JAX package's init of
    the chain), then the predict CLI on the golden images from the
    trainer's ``last`` checkpoint and the metric CLI on its output. The
    trainer's epoch rows are appended to ``history`` where one is given."""
    from enhax_torch.cli.predict import predict
    from enhax_torch.convert.jax_init import jax_init_state_dict
    from enhax_torch.models.base import build_model
    from enhax_torch.train import Trainer

    model = build_model(model_name, device=device, seed=0, **model_cfg)
    model.module.load_state_dict(jax_init_state_dict(name) if init is None else init)
    batch = training_batch(supervised, model.size_divisor)
    ckpt_dir = Path(out_root) / name / "ckpt"
    tr = Trainer(model, {"optimizer": {"name": "adam", "lr": lr},
                         "grad_clip_norm": 0.1 if not supervised else None},
                 max_epochs=epochs, ckpt_dir=ckpt_dir, log_every_n_steps=10**6)
    tr.fit(lambda: [batch], resume=False)
    if history is not None:
        history.extend(tr.history)
    pred_dir = predict({"model": model_name, "model_cfg": model_cfg,
                        "data": str(GOLDEN / "image"), "weights": str(ckpt_dir / "last"),
                        "save_dir": str(Path(out_root) / name / "pred"), "seed": 0,
                        "device": device})
    return {**chain_scores(pred_dir, GOLDEN / "ref", device), "epochs": epochs, "seed": 0,
            "model_cfg": model_cfg}


def run_chain(name, spec, out_root, device="cuda", weights=None) -> dict:
    """The predict -> metric chain without training (instance / tiled
    paths): the model's weights from the checkpoint the spec reuses, else
    ``weights`` (default: the JAX package's init of the chain, as its
    Predictor draws it)."""
    import torch

    from enhax_torch.cli.predict import predict
    from enhax_torch.convert.jax_init import jax_init_state_dict
    args = {k: v for k, v in spec.items() if not k.startswith("_")}
    if spec.get("_reuse_ckpt"):
        args["weights"] = str(Path(out_root) / spec["_reuse_ckpt"] / "ckpt" / "last")
    elif weights:
        args["weights"] = str(weights)
    elif "weights" not in args:
        path = Path(out_root) / name / "init.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(jax_init_state_dict(name), path)
        args["weights"] = str(path)
    pred_dir = predict({**args, "data": str(GOLDEN / "image"),
                        "save_dir": str(Path(out_root) / name / "pred"), "device": device})
    return {**chain_scores(pred_dir, GOLDEN / "ref", device), "seed": 0,
            "spec": {k: v for k, v in spec.items() if k != "model_cfg"}}


def run_video_chain(name, out_root, device="cuda") -> dict:
    """An 8-frame MJPG video of the golden scenes (cycled twice) through the
    predict CLI with ``hinet_tiny``'s checkpoint: ``video.mp4`` out, its
    frames extracted and scored against the cycled references."""
    from enhax_torch.cli.metric import measure_metric
    from enhax_torch.cli.predict import predict
    from enhax_torch.ops.io import read_image, write_image
    from enhax_torch.ops.video import VideoReaderCV, VideoWriterCV

    vdir = Path(out_root) / name
    vdir.mkdir(parents=True, exist_ok=True)
    frame_ids = [i % 4 for i in range(8)]
    w = VideoWriterCV(vdir / "in.avi", fps=8.0, fourcc="MJPG")
    for i in frame_ids:
        w.write(read_image(GOLDEN / "image" / f"{i:02d}.png"))
    w.close()
    pred_dir = predict({"model": "hinet_re",
                        "model_cfg": {"num_channels": 8, "depth": 2, "in_pos_right": 1},
                        "weights": str(Path(out_root) / "hinet_tiny" / "ckpt" / "last"),
                        "data": str(vdir / "in.avi"), "save_dir": str(vdir / "pred"), "seed": 0,
                        "device": device})
    out_vid = pred_dir / "video.mp4"
    if not out_vid.is_file():
        raise RuntimeError(f"predict did not write {out_vid}")
    (vdir / "frames").mkdir(exist_ok=True)
    (vdir / "ref").mkdir(exist_ok=True)
    n = 0
    for frame in VideoReaderCV(out_vid):
        write_image(vdir / "frames" / f"{n:02d}.png", frame)
        write_image(vdir / "ref" / f"{n:02d}.png",
                    read_image(GOLDEN / "ref" / f"{frame_ids[n]:02d}.png"))
        n += 1
    if n != 8:
        raise RuntimeError(f"expected 8 output frames, got {n}")
    scores = measure_metric({"input": str(vdir / "frames"), "target": str(vdir / "ref"),
                             "metric": ["psnr", "ssim"], "device": device})
    base = measure_metric({"input": str(GOLDEN / "image"), "target": str(GOLDEN / "ref"),
                           "metric": ["psnr", "ssim"], "device": device})
    return {"psnr": round(float(scores["psnr"]), 3), "ssim": round(float(scores["ssim"]), 4),
            "input_psnr": round(float(base["psnr"]), 3),
            "input_ssim": round(float(base["ssim"]), 4), "frames": n, "seed": 0,
            "spec": {"source": "8-frame MJPG avi of the golden scenes",
                     "model": "hinet_tiny ckpt reused", "writer": "predict CLI video.mp4"}}


def run_all(out_root, device="cuda") -> dict:
    """Every chain, in ``run/make_quality.py``'s order."""
    results = {}
    for name, model_name, model_cfg, supervised, epochs, lr in MODELS_UNDER_TEST:
        results[name] = run_one(name, model_name, model_cfg, supervised, epochs, lr, out_root,
                                device)
        print(f"[quality] {name}: {results[name]}", flush=True)
    for name, spec in EXTRA_CHAINS:
        results[name] = run_chain(name, spec, out_root, device)
        if spec.get("_delta_vs"):
            results[name]["delta_vs_untiled"] = round(
                results[name]["psnr"] - results[spec["_delta_vs"]]["psnr"], 3)
        print(f"[quality] {name}: {results[name]}", flush=True)
    results["video_chain"] = run_video_chain("video_chain", out_root, device)
    print(f"[quality] video_chain: {results['video_chain']}", flush=True)
    return results


def main(argv=None) -> dict:
    import tempfile
    p = argparse.ArgumentParser("enhax-torch-quality")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True, help="the JSON file the rows are written to")
    a = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="enhax_torch_quality_") as tmp:
        results = run_all(tmp, a.device)
    payload = {"golden_set": "assets/golden (4x 64x64, committed)",
               "protocol": "train at fixed seed on the golden set -> the port's predict CLI "
                           "-> the port's metric CLI", "device": a.device, "results": results}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(payload, indent=1) + "\n")
    print(f"[quality] -> {a.out}")
    return results


if __name__ == "__main__":
    main()
