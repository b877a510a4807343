"""The predict CLI's surface against the JAX package's CLI, on the CPU.

One set of JAX weights (``save_params_npz``) goes to both CLIs; each case
runs ``enhax.cli.predict`` and ``enhax_torch.cli.predict`` with the same
flags and compares what they write: the same file names and every PNG
within 1 uint8 level. Cases: ``--config`` (a train config naming the model,
its ``model_cfg`` and the data; a flag beating the config's model width),
a registered dataset name with ``--root``, ``--use-data-dir``,
``--use-fullpath`` (subfolders kept), ``--save-debug`` (HINet's ``stage1``
under ``debug/``), ``--no-save-image``, ``--benchmark`` (the params count;
the FLOPs are counted differently: XLA's cost analysis there, the products
and convolutions here), and a video in (an MJPG .avi) and ``video.mp4``
out: the same frame count and size, and the decoded frames of the two
videos within 1 uint8 level on average (the codec is lossy, so the two
encodes of frames 1 level apart are compared by their mean). The port's
trainer checkpoint directory serves its EMA shadow; a JAX orbax directory
raises, naming the conversion tool.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.cli.predict import main as jax_main
from enhax.models.base import build_model as jax_build_model
from enhax.train.checkpoints import save_params_npz
from enhax_torch.cli.predict import main
from enhax_torch.models.base import build_model
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.train.checkpoints import save_checkpoint
from enhax_torch.nn.optim import build_optimizer
from torch_threads import capped_torch_threads  # noqa: F401

DCE = {"num_channels": 8}
HINET = {"num_channels": 8, "depth": 2, "in_pos_right": 1}


def write_pngs(folder, names, seed=0, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    for name in names:
        path = folder / name
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), (rng.uniform(0, 0.4, (*hw, 3)) * 255).astype(np.uint8))


def npz(tmp_path, name, cfg):
    jm = jax_build_model(name, **cfg)
    v = jm.init(jax.random.PRNGKey(1), {"image": jnp.zeros((1, 32, 32, 3))})
    path = tmp_path / f"{name}.npz"
    save_params_npz(path, v)
    return path


def same_pngs(a, b):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*.png"))
    files_b = sorted(p.relative_to(b) for p in b.rglob("*.png"))
    assert files_a == files_b and files_a
    for rel in files_a:
        x = cv2.imread(str(a / rel)).astype(int)
        y = cv2.imread(str(b / rel)).astype(int)
        assert x.shape == y.shape and np.abs(x - y).max() <= 1, rel
    return files_a


def both(tmp_path, flags):
    """Each CLI with ``flags`` and its own save dir."""
    jax_main(flags + ["--save-dir", str(tmp_path / "jax")])
    main(flags + ["--save-dir", str(tmp_path / "torch"), "--device", "cpu"])
    return tmp_path / "jax", tmp_path / "torch"


def test_config_with_a_flag_over_it(tmp_path):
    write_pngs(tmp_path / "imgs", ["a.png", "b.png"])
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f'model = "hinet_re"\nmodel_cfg = {HINET!r}\ndata = "{tmp_path / "imgs"}"\n')
    weights = npz(tmp_path, "hinet_re", HINET)
    assert same_pngs(*both(tmp_path, ["--config", str(cfg), "--weights", str(weights)])) == [
        p.relative_to(tmp_path / "imgs") for p in sorted((tmp_path / "imgs").glob("*.png"))]
    # a flag beats the config: --data names another folder
    write_pngs(tmp_path / "imgs2", ["c.png"], seed=8)
    flags = ["--config", str(cfg), "--weights", str(weights), "--data", str(tmp_path / "imgs2")]
    jax_main(flags + ["--save-dir", str(tmp_path / "j2")])
    main(flags + ["--save-dir", str(tmp_path / "t2"), "--device", "cpu"])
    assert [str(n) for n in same_pngs(tmp_path / "j2", tmp_path / "t2")] == ["c.png"]


def test_dataset_name_with_root(tmp_path):
    write_pngs(tmp_path / "sice_mix" / "test" / "image", ["x.png", "y.png"], seed=1)
    write_pngs(tmp_path / "sice_mix" / "test" / "ref", ["x.png", "y.png"], seed=2)
    weights = npz(tmp_path, "zero_dce_re", DCE)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"model_cfg = {DCE!r}\n")
    names = same_pngs(*both(tmp_path, ["--model", "zero_dce_re", "--config", str(cfg),
                                       "--data", "sice_mix", "--root", str(tmp_path),
                                       "--weights", str(weights)]))
    assert [str(n) for n in names] == ["x.png", "y.png"]


def test_use_data_dir_and_fullpath(tmp_path, monkeypatch):
    import enhax.constants
    import enhax_torch.constants
    root = tmp_path / "data_dir"
    write_pngs(root / "set", ["top.png", "sub/deep.png", "sub/more/deeper.png"], seed=3)
    monkeypatch.setattr(enhax.constants, "DATA_DIR", root)
    monkeypatch.setattr(enhax_torch.constants, "DATA_DIR", root)
    monkeypatch.chdir(tmp_path)
    weights = npz(tmp_path, "zero_dce_re", {})
    names = same_pngs(*both(tmp_path, ["--model", "zero_dce_re", "--data", "set",
                                       "--use-data-dir", "--use-fullpath", "--weights",
                                       str(weights)]))
    assert [str(n) for n in names] == ["sub/deep.png", "sub/more/deeper.png", "top.png"]


def test_save_debug_and_no_save_image(tmp_path):
    write_pngs(tmp_path / "imgs", ["a.png"], seed=4)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"model_cfg = {HINET!r}\n")
    weights = npz(tmp_path, "hinet_re", HINET)
    flags = ["--model", "hinet_re", "--config", str(cfg), "--data", str(tmp_path / "imgs"),
             "--weights", str(weights)]
    names = same_pngs(*both(tmp_path, flags + ["--save-debug"]))
    assert [str(n) for n in names] == ["a.png", "debug/a_stage1.png"]
    jax_main(flags + ["--save-dir", str(tmp_path / "jn"), "--no-save-image"])
    main(flags + ["--save-dir", str(tmp_path / "tn"), "--no-save-image", "--device", "cpu"])
    assert not list(tmp_path.glob("jn/**/*.png")) and not list(tmp_path.glob("tn/**/*.png"))


def test_benchmark_reports_the_params(tmp_path, capfd):
    write_pngs(tmp_path / "imgs", ["a.png"], seed=5)
    weights = npz(tmp_path, "zero_dce_re", {})
    both(tmp_path, ["--model", "zero_dce_re", "--data", str(tmp_path / "imgs"), "--weights",
                    str(weights), "--benchmark"])
    # the JAX CLI's console reads its "[bench]" as markup and drops it
    lines = [ln for ln in capfd.readouterr().out.splitlines() if "Params(M)=" in ln]
    assert len(lines) == 2
    fields = [dict(kv.split("=") for kv in ln.split() if "=" in kv) for ln in lines]
    assert fields[0]["Params(M)"] == fields[1]["Params(M)"]
    assert float(fields[1]["FLOPs(G)"]) > 0 and float(fields[1]["t(s/img)"]) > 0


def test_video_in_and_out(tmp_path):
    from enhax_torch.ops.video import VideoReaderCV, VideoWriterCV
    rng = np.random.default_rng(6)
    frames = [rng.uniform(0, 0.4, (32, 48, 3)).astype(np.float32) for _ in range(5)]
    w = VideoWriterCV(tmp_path / "in.avi", fps=8.0, fourcc="MJPG")
    w.write_batch(frames)
    w.close()
    weights = npz(tmp_path, "zero_dce_re", {})
    jdir, tdir = both(tmp_path, ["--model", "zero_dce_re", "--data", str(tmp_path / "in.avi"),
                                 "--weights", str(weights)])
    assert sorted(p.name for p in jdir.iterdir()) == sorted(p.name for p in tdir.iterdir()) \
        == ["video.mp4"]
    ours = list(VideoReaderCV(tdir / "video.mp4"))
    ref = list(VideoReaderCV(jdir / "video.mp4"))
    assert len(ours) == len(ref) == 5 and ours[0].shape == ref[0].shape == (32, 48, 3)
    assert max(np.abs(a - b).mean() for a, b in zip(ours, ref)) * 255 <= 1.0


def test_checkpoint_directory_serves_the_ema(tmp_path):
    """A port trainer checkpoint directory: the EMA shadow's output, as the
    same weights given as a .pt; an orbax directory raises naming the tool."""
    write_pngs(tmp_path / "imgs", ["a.png"], seed=7)
    model = build_model("zero_dce_re", device="cpu", **DCE)
    tx = build_optimizer({"optimizer": {"name": "adam", "lr": 1e-2}})
    state = TrainState(0, model.module, tx.init(model.module.parameters()),
                       ema=build_model("zero_dce_re", device="cpu", seed=9, **DCE).module)
    step = make_train_step(model, tx, ema_decay=0.5)
    step(state, {"image": torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))})
    save_checkpoint(tmp_path / "ckpt", state, epoch=0)
    torch.save(state.ema.state_dict(), tmp_path / "ema.pt")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"model_cfg = {DCE!r}\n")
    for out, w in (("dir", tmp_path / "ckpt" / "last"), ("pt", tmp_path / "ema.pt")):
        main(["--model", "zero_dce_re", "--config", str(cfg), "--data", str(tmp_path / "imgs"),
              "--weights", str(w), "--save-dir", str(tmp_path / out), "--device", "cpu"])
    a = cv2.imread(str(tmp_path / "dir" / "a.png"))
    assert a is not None and np.array_equal(a, cv2.imread(str(tmp_path / "pt" / "a.png")))
    (tmp_path / "orbax" / "last").mkdir(parents=True)
    with pytest.raises(ValueError, match="jax_ckpt_to_torch"):
        main(["--model", "zero_dce_re", "--data", str(tmp_path / "imgs"), "--weights",
              str(tmp_path / "orbax" / "last"), "--save-dir", str(tmp_path / "o"),
              "--device", "cpu"])
