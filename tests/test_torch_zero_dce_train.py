"""Port parity: Zero-DCE training against the JAX package, on the CPU.

The four zero-reference losses (the spatial one at every ``num_regions``),
``zero_reference_loss`` on a model's outputs, and one float32 train step of
each Zero-DCE config (``configs/zero_dce_re_sice_mix.py``,
``configs/zero_dcepp_re_sice_mix.py``: Adam with weight decay 1e-5, the
gradient norm clipped to 0.1) on a tiny model against the JAX package's
step with the trainer's clip chained before the optimizer, as the JAX
``Trainer`` chains it. Also where the forward routes (a forward autograd
records takes ``apply_curves``, any other the curve kernels' wrappers)
and the train CLI with ``ENHAX_FUSED_TRAIN=1`` set for models without a
fused training path (``hinet_re``, ``zero_dce_re``), which train their
module as the JAX CLI does.

Tolerances: the losses 1e-5 x max(1, |ref|); the step as
``tests/test_torch_train.py`` holds NAFNet's: loss 1e-4 x max(1, |ref|),
gradients 1e-5 x max(1, max|ref|) per tensor, params after it within 1e-5.
"""

import csv
import math
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enhax.constants import LOSSES as JAX_LOSSES
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie.zero_dce import zero_reference_loss as jax_zero_reference_loss
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax.train.trainer import TrainState as JaxTrainState
from enhax.train.trainer import make_train_step as jax_make_train_step
from enhax_torch.cli import train as train_cli
from enhax_torch.constants import LOSSES
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import zero_dce
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.utils.config import load_config
from torch_train_parity import draw_like, flat_params
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_STEP_LOSS = 1e-4
TOL_GRAD = 1e-5
TOL_STEP_PARAM = 1e-5
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
ZERO_DCE = {"zero_dce_re": CONFIGS / "zero_dce_re_sice_mix.py",
            "zero_dce++_re": CONFIGS / "zero_dcepp_re_sice_mix.py"}
TINY = {"num_channels": 4}


def images(shape, seed=0, hi=1.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def assert_close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("name, kw", [
    ("spatial_consistency_loss", {"num_regions": 4}),
    ("spatial_consistency_loss", {"num_regions": 8}),
    ("spatial_consistency_loss", {"num_regions": 16}),
    ("spatial_consistency_loss", {"num_regions": 24, "patch_size": 3}),
    ("exposure_control_loss", {}),
    ("exposure_control_loss", {"patch_size": 8, "mean_val": 0.5, "reduction": "sum"}),
    ("color_constancy_loss", {}),
    ("total_variation_loss", {}),
    ("tv_loss", {"loss_weight": 3.0}),
    ("illumination_smoothness_loss", {}),
])
def test_losses_match_jax(name, kw):
    """On (2, 37, 45, 3): H and W not multiples of the pools, so both crop."""
    x, y = images((2, 37, 45, 3), 1), images((2, 37, 45, 3), 2)
    ours = LOSSES.build(name, **kw)(torch.from_numpy(x), torch.from_numpy(y))
    ref = JAX_LOSSES.build(name, **kw)(jnp.asarray(x), jnp.asarray(y))
    assert_close(ours, ref)


def test_spatial_consistency_refuses_other_region_counts():
    with pytest.raises(ValueError, match="num_regions"):
        LOSSES.build("spatial_consistency_loss", num_regions=6)


def test_zero_reference_loss_matches_jax():
    rng = np.random.default_rng(3)
    out = {"enhanced": images((2, 48, 64, 3), 4), "adjust": rng.uniform(-1, 1, (2, 48, 64, 24))
           .astype(np.float32)}
    dp = {"image": images((2, 48, 64, 3), 5, 0.3)}
    ours = zero_dce.zero_reference_loss()({k: torch.from_numpy(v) for k, v in out.items()},
                                          {k: torch.from_numpy(v) for k, v in dp.items()})
    ref = jax_zero_reference_loss()({k: jnp.asarray(v) for k, v in out.items()},
                                    {k: jnp.asarray(v) for k, v in dp.items()})
    assert_close(ours, ref)
    for name in ZERO_DCE:
        assert build_model(name, device="cpu", **TINY).loss_fn is not None


@pytest.mark.parametrize("name", list(ZERO_DCE))
def test_train_step_matches_jax(name):
    """One float32 step of the config's Adam (weight decay 1e-5) with the
    gradient norm clipped to 0.1: the loss, every gradient and every param."""
    cfg = load_config(ZERO_DCE[name])
    opt_cfg, clip = cfg["optimizer_cfg"], cfg["trainer_cfg"]["gradient_clip_val"]
    assert clip == 0.1 and opt_cfg["optimizer"]["weight_decay"] == 1e-5
    jm = jax_build_model(name, **TINY)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 16, 16, 3))})
    v = draw_like(struct, np.random.default_rng(8))
    batch = {"image": images((2, 32, 48, 3), 9, 0.3)}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(lambda p: jm.forward_loss(p, jb)[0]))(v)
    tx = optax.chain(optax.clip_by_global_norm(clip), jax_build_optimizer(opt_cfg))
    step = jax_make_train_step(jm, tx, donate=False)
    state, mets = step(JaxTrainState(step=0, params=v, opt_state=tx.init(v), ema=None), jb,
                       jax.random.PRNGKey(0))
    grads_ref = jax_to_torch_state_dict(name, flat_params(grads_ref))
    params_ref = jax_to_torch_state_dict(name, flat_params(state.params))
    # the clip is active: the gradient's norm is above 0.1
    assert math.sqrt(sum(float((g ** 2).sum()) for g in grads_ref.values())) > clip

    tm = build_model(name, device="cpu", **TINY)
    tm.module.load_state_dict(jax_to_torch_state_dict(name, flat_params(v)), strict=True)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    loss, _ = tm.forward_loss(tb)
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= TOL_STEP_LOSS * max(1.0, abs(float(loss_ref)))
    for k, p in tm.module.named_parameters():
        assert_close(p.grad, grads_ref[k], TOL_GRAD)
    tm.module.zero_grad(set_to_none=True)
    opt = build_optimizer(opt_cfg)
    m = make_train_step(tm, opt, gradient_clip_val=clip)(
        TrainState(0, tm.module, opt.init(tm.module.parameters())), tb)
    assert abs(m["loss"].item() - float(mets["loss"])) <= TOL_STEP_LOSS * max(
        1.0, abs(float(mets["loss"])))
    for k, t in tm.module.state_dict().items():
        assert float((t - params_ref[k]).abs().max()) <= TOL_STEP_PARAM, k


@pytest.mark.parametrize("name, kw", [("zero_dce_re", {}), ("zero_dce++_re", {}),
                                      ("zero_dce++_re", {"scale_factor": 4.0})])
def test_forward_routes_on_autograd(name, kw, monkeypatch):
    """A forward autograd records runs ``apply_curves`` (the kernels have no
    backward), a training forward and a grad-enabled serving call alike,
    and ``ZeroDCE.curve_loop_forwards`` counts each; under ``no_grad`` or
    ``inference_mode`` the curve kernel's wrapper runs, once, as in
    serving, and the count stays. All give the same result."""
    calls = []

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    for fn in ("apply_curves", "fused_curve_apply", "fused_curve_upsample_apply"):
        monkeypatch.setattr(zero_dce, fn, counted(getattr(zero_dce, fn)))
    model = build_model(name, device="cpu", **TINY, **kw)
    x = torch.from_numpy(images((1, 32, 48, 3), 10, 0.3))
    loops = zero_dce.ZeroDCE.curve_loop_forwards
    out = model.apply({"image": x}, training=True)
    assert calls == ["apply_curves"] and out["enhanced"].requires_grad
    assert zero_dce.ZeroDCE.curve_loop_forwards == loops + 1
    calls.clear()
    served = model.apply({"image": x})
    assert calls == ["apply_curves"] and zero_dce.ZeroDCE.curve_loop_forwards == loops + 2
    assert_close(served["enhanced"], out["enhanced"].detach().numpy(), 1e-6)
    kernel = "fused_curve_upsample_apply" if kw else "fused_curve_apply"
    for ctx in (torch.no_grad, torch.inference_mode):
        calls.clear()
        with ctx():
            served = model.apply({"image": x})
        assert calls == [kernel], ctx
        assert zero_dce.ZeroDCE.curve_loop_forwards == loops + 2
        assert_close(served["enhanced"], out["enhanced"].detach().numpy(), 1e-6)


# -- the train CLI with ENHAX_FUSED_TRAIN=1 for a model with no fused path -----------

def write_tree(root: Path, data: str, n_train: int = 4, n_test: int = 2, hw=(40, 48)) -> Path:
    """root/<data>/{train,test}/{image,ref}/NNN.png: degraded and clean pairs."""
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("test", n_test)):
        for sub in ("image", "ref"):
            (root / data / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            clean = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            cv2.imwrite(str(root / data / split / "image" / f"{i:03d}.png"), clean // 3)
            cv2.imwrite(str(root / data / split / "ref" / f"{i:03d}.png"), clean)
    return root


@pytest.mark.parametrize("config, data, model_cfg", [
    ("hinet_gopro.py", "gopro", {"num_channels": 4, "depth": 2, "in_pos_right": 1}),
    ("zero_dce_re_sice_mix.py", "sice_mix", TINY),
])
def test_train_cli_trains_the_module_under_fused_train(config, data, model_cfg, tmp_path,
                                                       monkeypatch, capsys):
    """The config as it is, with a tiny model_cfg, crops of 32 and batches
    of 2: two steps through the CLI with the switch set."""
    cfg = (CONFIGS / config).read_text()
    cfg += f"\nmodel_cfg = {model_cfg!r}\nimage_size = 32\n"
    cfg += "data_cfg = {'batch_size': 2, 'shuffle': True, 'num_workers': 0}\n"
    (tmp_path / "tiny.py").write_text(cfg)
    root = write_tree(tmp_path / "data", data)
    monkeypatch.setenv("ENHAX_FUSED_TRAIN", "1")
    state = train_cli.main(["--config", str(tmp_path / "tiny.py"), "--root", str(root),
                            "--device", "cpu", "--steps", "2",
                            "--save-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert state.step == 2 and "has no fused training path; training its module" in out
    rows = list(csv.DictReader(open(tmp_path / "run" / "log.csv")))
    assert rows and all(math.isfinite(float(r["train/loss"])) for r in rows)
    assert all(math.isfinite(float(r["val/loss"])) for r in rows)
