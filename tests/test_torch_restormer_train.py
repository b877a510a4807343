"""Port parity: Restormer-Rain13k training against the JAX package, on the CPU.

Three float32 train steps of a tiny Restormer (dim 8, blocks (1, 1, 1, 1),
one refinement block, 2x32x32) with ``configs/restormer_rain13k.py``'s AdamW
and cyclic restart schedule (its periods cut to 1 and 2 steps, so the lr
moves inside three steps), EMA 0.999, remat off and on, against the JAX
package's ``make_train_step``; the L1 loss; the EMA update re-preparing the
R1/R2 weights of the shadow the eval step serves; both packages' ``fit``
over three epochs of a tiny ``rain13k`` DataModule with a progressive patch
schedule; and the train CLI on a tiny copy of the config. One set of
weights, drawn with numpy, goes through the weight bridge into both
packages.

Tolerances: loss 1e-4 x max(1, |ref|); EMA 1e-5 x max(1, max|ref|);
params 2e-5 x max(1, max|ref|). An AdamW step moves a param by about lr =
3e-4 whatever its gradient's size, so an element whose gradient is near
zero carries the packages' float32 differences (gradients agree within
4.4e-6 of each tensor's max) into its update at a few % of a step: on this
draw one element of 208,213 is 1.42e-5 off after three steps, the next
6.3e-6 (2e-5 is 6.7% of one step).
"""

import copy
import csv
import math
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax.train.trainer import TrainState as JaxTrainState
from enhax.train.trainer import make_train_step as jax_make_train_step
from enhax_torch.kernels import _launch
from enhax_torch.kernels import restormer_block as rb
from enhax_torch.models.base import build_model
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.utils.config import load_config
from torch_train_parity import draw_like, to_port
from torch_threads import capped_torch_threads  # noqa: F401

TOL_LOSS = 1e-4
TOL_PARAM = 2e-5
TOL_EMA = 1e-5
TINY = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "heads": (1, 1, 2, 2)}
RAIN13K = str(Path(__file__).resolve().parents[1] / "configs" / "restormer_rain13k.py")


def optimizer_cfg() -> dict:
    """The config's optimizer, its cyclic periods cut from (92, 208) to
    (1, 2) steps: the first cycle's floor is the base lr (flat), so at the
    config's own periods three steps would not leave it; cut, the third
    step is half-way down the second cycle."""
    cfg = copy.deepcopy(load_config(RAIN13K)["optimizer_cfg"])
    cfg["lr_scheduler"]["scheduler"]["periods"] = [1, 2]
    return cfg


def batches(n: int, seed: int = 31) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        rain = np.clip(ref + rng.uniform(0, 0.3, ref.shape), 0, 1).astype(np.float32)
        out.append({"image": rain, "ref_image": ref})
    return out


def weights():
    jm = jax_build_model("restormer", **TINY)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    return jm, draw_like(struct, np.random.default_rng(12))


def jax_steps(remat: bool, jm, v) -> tuple:
    tx = jax_build_optimizer(optimizer_cfg())
    step = jax_make_train_step(jm, tx, donate=False, remat=remat, ema_decay=0.999)
    state = JaxTrainState(step=0, params=v, opt_state=tx.init(v),
                          ema=jax.tree_util.tree_map(jnp.copy, v))
    losses = []
    for b in batches(3):
        state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()}, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, to_port("restormer", state.params), to_port("restormer", state.ema)


def port_model(v):
    model = build_model("restormer", device="cpu", **TINY)
    model.module.load_state_dict(to_port("restormer", v), strict=True)
    return model


def port_state(model, tx) -> TrainState:
    return TrainState(step=0, module=model.module,
                      optimizer=tx.init(model.module.named_parameters()),
                      ema=copy.deepcopy(model.module).requires_grad_(False))


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(remat):
    jm, v = weights()
    ref_losses, ref_p, ref_e = jax_steps(remat, jm, v)
    model = port_model(v)
    tx = build_optimizer(optimizer_cfg())
    step = make_train_step(model, tx, remat=remat, ema_decay=0.999)
    state = port_state(model, tx)
    lrs = []
    for b, ref in zip(batches(3), ref_losses):
        loss = float(step(state, {k: torch.from_numpy(a) for k, a in b.items()})["loss"])
        assert abs(loss - ref) <= TOL_LOSS * max(1.0, abs(ref)), (loss, ref)
        lrs.append(state.optimizer.param_groups[0]["lr"])
    assert lrs[0] == lrs[1] == 3e-4 and lrs[2] == pytest.approx(0.5 * (3e-4 + 1e-6))
    params, ema = state.module.state_dict(), state.ema.state_dict()
    for k, t in ref_p.items():
        for got, want, tol, what in ((params[k], t, TOL_PARAM, k),
                                     (ema[k], ref_e[k], TOL_EMA, "ema " + k)):
            err = float((got - want).abs().max())
            assert err <= tol * max(1.0, float(want.abs().max())), (what, err)


def test_loss_is_l1_of_enhanced_against_ref():
    """The model's ``loss_fn`` against the JAX model's on the same outputs."""
    jm = jax_build_model("restormer", **TINY)
    model = build_model("restormer", device="cpu", **TINY)
    rng = np.random.default_rng(4)
    out, ref = (rng.uniform(-0.2, 1.2, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    got = model.loss_fn({"enhanced": torch.from_numpy(out)}, {"ref_image": torch.from_numpy(ref)})
    want = jm.loss_fn({"enhanced": jnp.asarray(out)}, {"ref_image": jnp.asarray(ref)})
    assert abs(float(got) - float(want)) <= 1e-6
    assert not model.trains_fused   # R1/R2 have no backward: the module trains


def test_ema_update_reprepares_the_eval_weights():
    """The eval step serves the EMA shadow, whose R1/R2 weights are prepared
    once per tensor version. ``update_ema``'s foreach ops bump every
    shadow parameter's version, so the next eval prepares each block's
    weights anew (two makes a block), from the updated shadow; a second
    eval without a step prepares nothing."""
    model = build_model("restormer", device="cpu", **TINY)
    tx = build_optimizer(optimizer_cfg())
    state = port_state(model, tx)
    step = make_train_step(model, tx, ema_decay=0.999)
    blocks = [m for m in state.ema.modules() if type(m).__name__ == "RestormerBlock"]

    def prepare_all():
        with torch.inference_mode():
            return [(rb.r1_weights(dict(b.named_parameters()), False),
                     rb.r2_weights(dict(b.named_parameters()), False)) for b in blocks]

    prepare_all()
    before = _launch.prepared.makes
    prepare_all()
    assert _launch.prepared.makes == before
    versions = [p._version for p in state.ema.parameters()]
    step(state, {k: torch.from_numpy(a) for k, a in batches(1)[0].items()})
    assert all(p._version > v for p, v in zip(state.ema.parameters(), versions))
    got = prepare_all()
    assert _launch.prepared.makes == before + 2 * len(blocks)
    # the prepared layout is the updated shadow's
    b = blocks[0]
    w = b.attn.qkv.weight.detach()
    assert torch.equal(got[0][0][2].reshape(w.shape), w.float())


def write_rain13k(root: Path, n_train: int, n_test: int, hw: int, seed: int = 3) -> Path:
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        for sub in ("image", "ref"):
            (root / "rain13k" / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            clean = rng.integers(0, 256, (hw, hw + 8, 3), dtype=np.uint8)
            rain = np.clip(clean + rng.integers(0, 60, clean.shape), 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / "rain13k" / split / "image" / f"{i:03d}.png"), rain)
            cv2.imwrite(str(root / "rain13k" / split / "ref" / f"{i:03d}.png"), clean)
    return root


PROGRESSIVE = {"milestones": (0, 1, 2), "sizes": (16, 24, 32), "batch_sizes": (4, 3, 2)}


def recorded(dm, log: list):
    """dm.train_loader with each batch's image shape and file names logged.
    The loader is called at once, as the Trainer's calls count the epochs."""
    def loader():
        batches = dm.train_loader()

        def logged():
            for b in batches:
                log.append((b["image"].shape,
                            [str(m.get("name", m.get("path"))) for m in b["meta"]]))
                yield b
        return logged()
    return loader


def test_fit_follows_the_progressive_schedule_as_jax(tmp_path):
    """Both packages' ``fit`` over 3 epochs of a 12-pair ``rain13k``
    DataModule (shuffled, seed 0, drop_last) with a progressive schedule:
    each epoch the same batch sizes, crop sizes and file order (the crop
    positions differ: the JAX hook draws them unseeded)."""
    from enhax.constants import DATAMODULES as JAX_DATAMODULES
    from enhax.train import ProgressiveTrainingHook as JaxProgressive
    from enhax.train import Trainer as JaxTrainer
    from enhax_torch.constants import DATAMODULES
    from enhax_torch.train import ProgressiveTrainingHook, Trainer
    root = write_rain13k(tmp_path, 12, 2, 40)
    opt = {"optimizer": {"name": "adam", "lr": 1e-3}}
    logs = {}
    for pkg in ("jax", "port"):
        reg = JAX_DATAMODULES if pkg == "jax" else DATAMODULES
        dm = reg.build("rain13k", root=root, batch_size=8, shuffle=True, drop_last=True)
        dm.setup()
        if pkg == "jax":
            hook = JaxProgressive(dm, **PROGRESSIVE)
            tr = JaxTrainer(jax_build_model("zero_dce_re", num_channels=4), opt, max_epochs=3,
                            hooks=[hook], log_every_n_steps=1000)
        else:
            hook = ProgressiveTrainingHook(dm, **PROGRESSIVE, seed=0)
            tr = Trainer(build_model("zero_dce_re", device="cpu", num_channels=4), opt,
                         max_epochs=3, hooks=[hook], log_every_n_steps=1000)
        logs[pkg] = []
        tr.fit(recorded(dm, logs[pkg]), resume=False)
        assert [r["epoch"] for r in tr.history] == [0, 1, 2]
    # JAX's fit draws a batch of its own to build the state (the port calls
    # the loader there and draws nothing: fault 3.5's repair)
    assert logs["jax"][1:] == logs["port"]
    shapes = [s for s, _ in logs["port"]]
    assert shapes == [(4, 16, 16, 3)] * 3 + [(3, 24, 24, 3)] * 4 + [(2, 32, 32, 3)] * 6


TINY_CONFIG = f"""
exec(open({RAIN13K!r}).read())
model_cfg = {TINY!r}
progressive = {{"milestones": (0, 1, 2), "sizes": (16, 24, 32), "batch_sizes": (4, 3, 2)}}
trainer_cfg = dict(trainer_cfg, log_every_n_steps=1000,
                   callbacks=["timer", {{"name": "learning_rate_monitor"}}])
"""


def test_train_cli_trains_restormer_with_progressive_patches(tmp_path, monkeypatch, capsys):
    """The train CLI on configs/restormer_rain13k.py with a tiny model and
    the milestones cut to epochs 0, 1, 2 (crops 16, 24, 32, batches 4, 3, 2),
    12 train pairs: three epochs whose batches have the schedule's crop and
    batch sizes, ``last`` and ``best`` checkpoints, a finite ``val/psnr``
    each epoch, the callbacks' columns in the log, and ``--weights``
    accepted and not read."""
    from enhax_torch.cli import train as train_cli
    from enhax_torch.train import trainer as trainer_mod
    root = write_rain13k(tmp_path / "data", 12, 2, 40)
    (tmp_path / "tiny.py").write_text(TINY_CONFIG)
    shapes = []
    make = trainer_mod.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(state, batch):
            shapes.append(tuple(batch["image"].shape))
            return step(state, batch)
        return wrapped

    monkeypatch.setattr(trainer_mod, "make_train_step", recording)
    state = train_cli.main(["--config", str(tmp_path / "tiny.py"), "--root", str(root),
                            "--device", "cpu", "--epochs", "3", "--weights", "w.pth",
                            "--save-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "--weights w.pth is not read" in out
    assert shapes == [(4, 16, 16, 3)] * 3 + [(3, 24, 24, 3)] * 4 + [(2, 32, 32, 3)] * 6
    assert state.step == 13
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "last" / "state.pt").is_file() and (ckpt / "best" / "state.pt").is_file()
    rows = list(csv.DictReader(open(tmp_path / "run" / "log.csv")))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert all(math.isfinite(float(r["val/psnr"])) for r in rows)
    assert all(r["elapsed_s"] for r in rows[:-1])   # the hooks' keys reach the next write
