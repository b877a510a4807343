"""Port parity on the CPU: SCI through both packages' train CLIs for 2 steps
on a fabricated ``sice_mix`` tree of 32x32 images (a config written here:
SCI's published width, Adam with weight decay), the port from the JAX
trainer's init; every logged loss and every parameter within 1e-5 x
max(1, max|ref|), the BatchNorm statistics untouched in both."""

import numpy as np

from torch_family_parity import assert_clis_agree, fabricate, run_both_clis
from torch_threads import capped_torch_threads  # noqa: F401


def _dp(n=2, hw=32, seed=11):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.02, 0.5, (n, hw, hw, 3)).astype(np.float32)}


def test_sci_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"sice_mix/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.4)), ("ref", (0.2, 1.0)))})
    config = tmp_path / "sci_tiny.py"
    config.write_text("model = 'sci'\n"
                      "model_cfg = {}\n"
                      "data = 'sice_mix'\n"
                      "data_cfg = {'batch_size': 2, 'shuffle': True}\n"
                      "image_size = 32\n"
                      "optimizer_cfg = {'optimizer': {'name': 'adam', 'lr': 3e-4, "
                      "'betas': (0.9, 0.999), 'weight_decay': 3e-4}}\n"
                      "trainer_cfg = {'max_epochs': 2, 'limit_val_batches': 0}\n"
                      "seed = 2\n")
    example = {**_dp(), "ref_image": _dp()["image"]}
    jrun, prun, name = run_both_clis(config, root, tmp_path, monkeypatch, example)
    assert name == "sci"
    assert_clis_agree(jrun, prun, name)
