"""Port parity: the data pipeline, configs, checkpoints and the train CLI,
on the CPU.

A SIDD-shaped tree of PNG pairs under ``tmp_path``: for the same seeds the
port's ``sidd`` DataModule gives the batches the JAX package's gives (order,
``RandomCrop`` windows, ``ref_image`` pairing; arrays equal, both decode
with OpenCV) over two epochs, whatever its number of decode threads. The
config loader reads ``configs/nafnet_sidd.py`` as the JAX loader does; the
dataset table registers every JAX row. Checkpoints round-trip, and the
train CLI (``--device cpu``, a tiny NAFNet config) trains, writes ``last``,
``best`` and the CSV log, resumes at its step, and with
``ENHAX_FUSED_TRAIN=1`` trains through ``nafblock_fused``. A CUDA device
without a card raises.
"""

import csv
import math
import signal
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from enhax.constants import DATAMODULES as JAX_DATAMODULES
from enhax.data.transforms import RandomCrop as JaxRandomCrop
from enhax.utils.config import load_config as jax_load_config
from enhax.utils.config import merge_configs as jax_merge_configs
from enhax_torch.cli import train as train_cli
from enhax_torch.constants import DATAMODULES
from enhax_torch.data import Compose, RandomCrop, RandomFlip, batch_iterator, prefetch_to_device
from enhax_torch.kernels import nafblock
from enhax_torch.models.base import build_model
from enhax_torch.train import Trainer, latest_checkpoint, load_checkpoint, save_checkpoint
from enhax_torch.utils.config import load_config, merge_configs, parse_config_file
from torch_train_parity import jax_run, port_run, sidd_optimizer_cfg
from torch_threads import capped_torch_threads  # noqa: F401

SIDD = str(Path(__file__).resolve().parents[1] / "configs" / "nafnet_sidd.py")
TOL_BF16_LOSS = 2e-2
TINY = {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1), "dec_blk_nums": (1, 1)}
TINY_CONFIG = '''model = "nafnet"
model_cfg = {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1), "dec_blk_nums": (1, 1)}
data = "sidd"
data_cfg = {"batch_size": 2, "shuffle": True, "drop_last": True, "num_workers": 2}
image_size = 32
optimizer_cfg = {
    "optimizer": {"name": "adamw", "lr": 1e-3, "betas": (0.9, 0.9), "weight_decay": 0.0},
    "lr_scheduler": {"scheduler": {"name": "cosine_annealing_lr", "t_max": 200,
                                   "eta_min": 1e-7}},
}
trainer_cfg = {"max_epochs": 200, "monitor": ("psnr", "max"), "remat": True,
               "ema_decay": 0.999, "log_every_n_steps": 1}
seed = 10
'''


def write_sidd(root, n_train: int = 7, n_test: int = 2, hw=(40, 48), seed: int = 0):
    """root/sidd/{train,test}/{image,ref}/NNN.png: noisy and clean pairs."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        for sub in ("image", "ref"):
            (root / "sidd" / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            clean = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            noisy = np.clip(clean.astype(int) + rng.integers(-20, 21, clean.shape), 0, 255)
            cv2.imwrite(str(root / "sidd" / split / "image" / f"{i:03d}.png"),
                        noisy.astype(np.uint8))
            cv2.imwrite(str(root / "sidd" / split / "ref" / f"{i:03d}.png"), clean)
    return root


@pytest.fixture
def sidd_root(tmp_path):
    return write_sidd(tmp_path / "data")


def epochs_of(dm, n_epochs: int = 2) -> list:
    dm.setup()
    out = []
    for _ in range(n_epochs):
        out.append([(b["image"], b["ref_image"], [m["path"] for m in b["meta"]])
                    for b in dm.train_loader()])
    return out


@pytest.mark.parametrize("num_workers", [0, 3])
def test_sidd_datamodule_batches_match_jax(sidd_root, num_workers):
    """Order, crop windows and pairing equal JAX's for the same seeds, over
    two epochs (a reshuffle with seed + epoch each); the port's decode
    threads do not change them (JAX's with none)."""
    kw = {"root": str(sidd_root), "batch_size": 2, "shuffle": True, "drop_last": True,
          "seed": 5}
    jdm = JAX_DATAMODULES.build("sidd", num_workers=0,
                                transform=JaxRandomCrop(24, seed=3), **kw)
    tdm = DATAMODULES.build("sidd", num_workers=num_workers, transform=RandomCrop(24, seed=3),
                            **kw)
    ref, got = epochs_of(jdm), epochs_of(tdm)
    assert [len(e) for e in got] == [3, 3]  # 7 pairs, batches of 2, the last dropped
    assert [p for b in got[0] for p in b[2]] != [p for b in got[1] for p in b[2]]
    for e_ref, e_got in zip(ref, got):
        for (ri, rr, rp), (gi, gr, gp) in zip(e_ref, e_got):
            assert gp == rp
            assert gi.shape == (2, 24, 24, 3) and gi.dtype == np.float32
            np.testing.assert_array_equal(gi, ri)
            np.testing.assert_array_equal(gr, rr)
    # ref_image is the clean image of the same name
    pairs = tdm.train.datapoints
    assert [a.path.name for a in pairs["image"]] == [a.path.name for a in pairs["ref_image"]]
    assert all(a.path.parent.name == "ref" for a in pairs["ref_image"])


def test_fit_consumes_the_batches_jax_fit_does(sidd_root):
    """Both packages' ``Trainer.fit`` over two epochs of one DataModule
    train on the same batches in the same order. The JAX package draws a
    batch to build its state, which advances the DataModule's epoch
    counter; the port's ``fit`` calls ``train_iter_fn`` once there too and
    draws nothing from it."""
    from enhax.models.base import build_model as jax_build_model
    from enhax.train.trainer import Trainer as JaxTrainer

    kw = {"root": str(sidd_root), "batch_size": 2, "shuffle": True, "drop_last": True,
          "seed": 5, "num_workers": 0}
    opt = {"optimizer": {"name": "adam", "lr": 1e-4}}

    def recorded(dm, calls):
        dm.setup()

        def train_iter_fn():
            it = dm.train_loader()   # a new shuffle each call
            drawn = []
            calls.append(drawn)

            def batches():
                for b in it:
                    drawn.append([m["path"] for m in b["meta"]])
                    yield b
            return batches()
        return train_iter_fn

    ref, got = [], []
    JaxTrainer(jax_build_model("zero_dce_re", num_channels=4), opt, max_epochs=2,
               log_every_n_steps=100).fit(recorded(JAX_DATAMODULES.build("sidd", **kw), ref))
    Trainer(build_model("zero_dce_re", device="cpu", num_channels=4), opt, max_epochs=2,
            log_every_n_steps=100).fit(recorded(DATAMODULES.build("sidd", **kw), got))
    assert len(ref) == len(got) == 3 and len(ref[0]) == 1 and got[0] == []
    assert [len(e) for e in got[1:]] == [3, 3] and got[1] != got[2]
    assert got[1:] == ref[1:]


def test_val_split_and_summaries(sidd_root):
    dm = DATAMODULES.build("sidd", root=str(sidd_root), batch_size=4)
    dm.setup()
    assert len(dm.train) == 7 and len(dm.val) == 2 and len(dm.test) == 2
    (batch,) = list(dm.val_loader())
    assert batch["image"].shape == (2, 40, 48, 3)


def test_transforms_share_one_window_and_draw_from_their_seed():
    rng = np.random.default_rng(1)
    dp = {"image": rng.uniform(size=(20, 30, 3)).astype(np.float32)}
    dp["ref_image"] = dp["image"] + 1
    out = Compose([RandomCrop(8, seed=4), RandomFlip(p=0.5, vertical=True, seed=4)])(dict(dp))
    assert out["image"].shape == (8, 8, 3)
    np.testing.assert_array_equal(out["ref_image"], out["image"] + 1)
    again = Compose([RandomCrop(8, seed=4), RandomFlip(p=0.5, vertical=True, seed=4)])(dict(dp))
    np.testing.assert_array_equal(again["image"], out["image"])


def test_dataset_table_registers_every_jax_row():
    assert set(DATAMODULES.keys()) == set(JAX_DATAMODULES.keys())


def test_batch_iterator_drop_last_and_order():
    data = [{"image": np.full((2, 2, 1), i, np.float32)} for i in range(5)]
    got = [b["image"][:, 0, 0, 0].tolist() for b in batch_iterator(data, 2, drop_last=True)]
    assert got == [[0, 1], [2, 3]]
    got = [b["image"][:, 0, 0, 0].tolist() for b in batch_iterator(data, 2, num_workers=2)]
    assert got == [[0, 1], [2, 3], [4]]


def test_prefetch_to_device_moves_batches_and_raises_their_errors():
    batches = [{"image": np.full((1, 2, 2, 3), i, np.float32), "meta": ["x"]} for i in range(4)]
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert [float(b["image"][0, 0, 0, 0]) for b in got] == [0, 1, 2, 3]
    assert all(isinstance(b["image"], torch.Tensor) and "meta" not in b for b in got)

    def broken():
        yield batches[0]
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(prefetch_to_device(broken(), "cpu"))
    # a consumer that stops early stops the thread
    threads = threading.active_count()
    it = prefetch_to_device(iter(batches * 50), "cpu", size=1)
    next(it)
    it.close()
    assert threading.active_count() == threads


# -- configs ------------------------------------------------------------------------

def test_config_loading_matches_jax(tmp_path):
    assert load_config(SIDD) == jax_load_config(SIDD)
    found = parse_config_file("nafnet_sidd", search_dirs=[Path(SIDD).parents[1]])
    assert found.name == "nafnet_sidd.py"
    base = {"a": {"b": 1, "c": (1, 2)}, "d": 3}
    over = {"a": {"b": None, "c": 5}, "e": {"f": 1}}
    assert merge_configs(base, over) == jax_merge_configs(base, over)
    (tmp_path / "x.yaml").write_text("a: 1\n")
    with pytest.raises(NotImplementedError, match="1.12"):
        load_config(tmp_path / "x.yaml")


# -- checkpoints and the trainer ------------------------------------------------------

def tiny_model():
    return build_model("nafnet", device="cpu", seed=1, **TINY)


def numpy_batches(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        out.append({"image": np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1)
                    .astype(np.float32), "ref_image": ref})
    return out


def test_checkpoint_round_trip(tmp_path):
    cfg = load_config(SIDD)
    tr = Trainer(tiny_model(), cfg["optimizer_cfg"], max_epochs=1, ema_decay=0.999,
                 log_every_n_steps=1)
    state = tr.fit(lambda: iter(numpy_batches(3)), resume=False)
    path = save_checkpoint(tmp_path / "ckpt", state, epoch=4)
    assert latest_checkpoint(tmp_path / "ckpt") == path
    fresh = Trainer(tiny_model(), cfg["optimizer_cfg"], ema_decay=0.999)
    restored, epoch = load_checkpoint(path, fresh.init_state())
    assert epoch == 5 and restored.step == state.step == 3
    for a, b in ((restored.module, state.module), (restored.ema, state.ema)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), k
    sa, sb = restored.optimizer.state_dict(), state.optimizer.state_dict()
    assert sa["param_groups"][0]["lr"] == sb["param_groups"][0]["lr"]
    for k in sb["state"]:
        assert torch.equal(sa["state"][k]["exp_avg_sq"], sb["state"][k]["exp_avg_sq"])
    other = build_model("nafnet", device="cpu", width=16, middle_blk_num=1,
                        enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_checkpoint(path, Trainer(other, cfg["optimizer_cfg"]).init_state())


def test_trainer_knobs():
    cfg = load_config(SIDD)["optimizer_cfg"]
    data = numpy_batches(4)
    seen = []

    def loader():
        seen.append(1)
        return iter(data)

    tr = Trainer(tiny_model(), cfg, fast_dev_run=True)
    assert tr.fit(loader, loader, resume=False).step == 1
    assert set(tr.history[0]) >= {"train/loss", "train/psnr", "val/psnr", "val/ssim",
                                  "val/loss"}
    tr = Trainer(tiny_model(), cfg, max_epochs=3, limit_train_batches=2)
    assert tr.fit(loader, resume=False).step == 6
    tr = Trainer(tiny_model(), cfg, max_epochs=3, overfit_batches=1, max_steps=2)
    seen.clear()
    # one call builds the state (as the JAX package's fit draws its first
    # batch there), one fills the overfit cache, which every epoch reuses
    assert tr.fit(loader, resume=False).step == 2 and len(seen) == 2
    with pytest.raises(NotImplementedError, match="1.14"):
        Trainer(tiny_model(), cfg, strategy="ddp")
    # hooks, accumulation and log_image_every_n_epochs are ported: two
    # epochs of 4 mini-batches in pairs are 4 updates and two hook calls
    rows = []
    tr = Trainer(tiny_model(), cfg, max_epochs=2, accumulate_grad_batches=2,
                 log_image_every_n_epochs=1, hooks=[lambda t, s, r: rows.append(r["epoch"])])
    state = tr.fit(loader, resume=False)
    assert state.step == 8 and rows == [0, 1]
    assert state.optimizer.state_dict()["state"][0]["step"] == 4


def test_sigterm_checkpoints_and_stops(tmp_path):
    """The preemption path: SIGTERM during an epoch finishes it, saves
    ``last`` and returns; the previous handler comes back."""
    cfg = load_config(SIDD)["optimizer_cfg"]
    data = numpy_batches(2)

    def loader():
        for i, b in enumerate(data):
            if i == 1:
                signal.raise_signal(signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(tiny_model(), cfg, max_epochs=5, ckpt_dir=tmp_path / "ckpt")
    state = tr.fit(loader, resume=False)
    assert state.step == 2 and len(tr.history) == 1
    assert latest_checkpoint(tmp_path / "ckpt").name == "last"
    assert signal.getsignal(signal.SIGTERM) == before


# -- the train CLI -----------------------------------------------------------------

def run_cli(tmp_path, root, steps: int) -> None:
    train_cli.main(["--config", str(tmp_path / "tiny.py"), "--root", str(root),
                    "--device", "cpu", "--steps", str(steps),
                    "--save-dir", str(tmp_path / "run")])


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, sidd_root, monkeypatch, capsys):
    (tmp_path / "tiny.py").write_text(TINY_CONFIG)
    run_cli(tmp_path, sidd_root, 2)
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "last" / "state.pt").is_file() and (ckpt / "best" / "state.pt").is_file()
    assert torch.load(ckpt / "last" / "state.pt", weights_only=True)["step"] == 2
    # the second run resumes at step 2, with the fused training forward
    calls = []
    fused = nafblock.nafblock_fused

    def counted(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    monkeypatch.setattr(nafblock, "nafblock_fused", counted)
    monkeypatch.setenv("ENHAX_FUSED_TRAIN", "1")
    run_cli(tmp_path, sidd_root, 4)
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out and "done at step 4" in out
    # all 5 blocks (C = 8, 16, 32 <= 64) fused, twice a step under remat, 2 steps
    assert len(calls) == 5 * 2 * 2
    assert torch.load(ckpt / "last" / "state.pt", weights_only=True)["step"] == 4
    rows = list(csv.DictReader(open(tmp_path / "run" / "log.csv")))
    assert rows and all(math.isfinite(float(r["train/loss"])) for r in rows)
    assert all(math.isfinite(float(r["val/psnr"])) for r in rows)


def test_train_cli_refuses_what_is_not_there(tmp_path, sidd_root, monkeypatch):
    (tmp_path / "tiny.py").write_text(TINY_CONFIG)
    base = ["--config", str(tmp_path / "tiny.py"), "--root", str(sidd_root), "--steps", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(base + ["--device", "cuda"])
    for flag, item in ((["--strategy", "ddp"], "1.14"), (["--devices", "2"], "1.14")):
        with pytest.raises(NotImplementedError, match=item):
            train_cli.main(base + ["--device", "cpu"] + flag)


# -- the bf16-mixed train step ---------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax_bf16_mixed(remat):
    """bf16-mixed: the same three steps with bf16 copies of params and batch
    in the forward; params stay float32. The packages round their bf16
    forwards at other places, and Adam moves a param by about lr whatever
    its gradient's size, so a gradient near zero that rounds to the other
    sign moves it 2 lr the other way. Held to: loss and psnr within 2e-2 x
    max(1, |ref|); after n steps every param within 2 lr n (x 1.001 for the
    float32 rounding of the updates), their mean |d| within 0.1 lr n, at most
    5% of them more than lr / 2 off; the EMA, which takes (1 - decay) of each
    step's params, within (1 - decay) lr n (n + 1) x 1.001 plus 1e-6 (a few
    float32 steps of the shadow's own rounding, values near 1)."""
    lr = sidd_optimizer_cfg()["optimizer"]["lr"]
    ref_m, ref_s = jax_run(remat, "bf16-mixed")
    mets, snaps = port_run(remat, "bf16-mixed", fused=False)
    for m, r in zip(mets, ref_m):
        for k in ("loss", "psnr"):
            assert abs(m[k] - r[k]) <= TOL_BF16_LOSS * max(1.0, abs(r[k])), (k, m[k], r[k])
    for n in (1, 3):
        params, ema = snaps[n]
        ref_p, ref_e = ref_s[n]
        assert all(params[k].dtype == torch.float32 for k in ref_p)
        d = torch.cat([(params[k] - t).abs().flatten() for k, t in ref_p.items()])
        assert float(d.max()) <= 2 * lr * n * 1.001, (n, float(d.max()) / lr)
        assert float(d.mean()) <= 0.1 * lr * n, (n, float(d.mean()) / lr)
        assert float((d > lr / 2).float().mean()) <= 0.05, n
        e = max(float((ema[k] - t).abs().max()) for k, t in ref_e.items())
        assert e <= (1 - 0.999) * lr * n * (n + 1) * 1.001 + 1e-6, (n, e / lr)
