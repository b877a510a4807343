"""Port parity: HINet against the JAX package, on the CPU.

One set of weights, drawn with numpy, goes through the weight bridge into
both packages: ``hinet_re`` at QUALITY.json's tiny config (width 8, depth
2, HIN at blocks 0-1) and at the published width (64, depth 5,
88,669,702 params) on 1x64x64, both outputs (``stage1``, ``enhanced``);
the bridge at depths 2, 3 and 5; the released ``.pth`` naming (the
independent torch HINet of ``tests/test_convert_hinet.py``, its strided
conv under the released name ``downsample``) loaded strictly; the
``Predictor`` (padding to 16), the predict CLI and tiled serving with
``hinet_tiny_tiled``'s spec (tile 32, overlap 8, uniform blend, per-tile
instance-norm statistics); and one float32 train step of
``configs/hinet_gopro.py``'s Adam against the JAX package's train step,
with the restart schedule at its period boundaries.

The bf16 ``Predictor`` is held against the JAX package's bf16 ``Predictor``
on the same weights at both widths.

Tolerances: outputs 1e-4 x max(1, max|ref|) (the JAX and torch convs sum
in other orders through 30 convs), in bf16 3e-2 x max(1, max|ref|) and
the mean gap within twice the JAX package's own bf16-vs-f32 mean gap; the step as ``tests/test_torch_train.py``
holds NAFNet's: loss 1e-4 x max(1, |ref|), gradients 1e-5 x max(1,
max|ref|) per tensor, params after the step within 1e-5, except the
normalised half of a HIN conv's bias, whose gradient is 0 in exact
arithmetic (within 2 lr, the two signs Adam's first step can take); the
schedule 1e-6 x base lr (JAX computes it in float32).
"""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.constants import LR_SCHEDULERS as JAX_LR_SCHEDULERS
from enhax.infer import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax.train.trainer import TrainState as JaxTrainState
from enhax.train.trainer import make_train_step as jax_make_train_step
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.nn.optim import build_optimizer, build_schedule
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.utils.config import load_config
from test_convert_hinet import TorchHINet
from torch_train_parity import draw_like, flat_params
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-4
TOL_STEP_LOSS = 1e-4
TOL_GRAD = 1e-5
# bf16 serving: each package rounds every op's output to bfloat16 in its own
# order; the two bf16 Predictors differ by 1.0-1.6e-2 x max(1, max|ref|) on
# the CPU at both widths, as much as the JAX package's bf16 differs from its
# float32
TOL_BF16 = 3e-2
TOL_STEP_PARAM = 1e-5
TINY = {"num_channels": 8, "depth": 2, "in_pos_right": 1}   # QUALITY.json hinet_tiny
TILE = (32, 32, 8)                                            # hinet_tiny_tiled
GOPRO = str(Path(__file__).resolve().parents[1] / "configs" / "hinet_gopro.py")
# the tiny config's biases of a conv whose output is instance-normalised
CANCELLED = {f"down_path_{s}.{i}.conv_1.bias" for s in (1, 2) for i in range(2)}


def weights(kw: dict, seed: int = 0):
    """The JAX model and variables drawn with numpy (biases and instance
    norm scales off their init), and the port's model loaded through the
    bridge."""
    jm = jax_build_model("hinet_re", **kw)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 32, 32, 3))})
    v = draw_like(struct, np.random.default_rng(seed))
    tm = build_model("hinet_re", device="cpu", **kw)
    tm.module.load_state_dict(jax_to_torch_state_dict("hinet_re", flat_params(v)), strict=True)
    return jm, v, tm


def frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


@pytest.fixture(scope="module")
def tiny():
    return weights(TINY)


@pytest.fixture(scope="module")
def published():
    return weights({})


@pytest.mark.parametrize("config", ["tiny", "published"])
def test_hinet_matches_jax(config, request):
    jm, v, tm = request.getfixturevalue(config)
    if config == "published":
        assert tm.param_count() == 88_669_702
    x = frames((1, 64, 64, 3), seed=1)
    ref = jax.jit(jm.apply)(v, {"image": jnp.asarray(x)})
    with torch.no_grad():
        out = tm.apply({"image": torch.from_numpy(x)})
    for key in ("stage1", "enhanced"):
        close(out[key].numpy(), ref[key])


@pytest.mark.parametrize("config", ["tiny", "published"])
def test_bf16_predictor_matches_jax_bf16(config, request):
    """The bf16 Predictor (weights and activations in bfloat16, the instance
    norms' statistics taken in float32) against the JAX package's bf16
    Predictor on the same weights, both outputs: max|d| within TOL_BF16 x
    max(1, max|ref|), and the mean |d| within twice the JAX package's own
    gap between its bf16 and float32 outputs."""
    jm, v, tm = request.getfixturevalue(config)
    x = frames((1, 64, 96, 3), seed=7)
    ref = JaxPredictor(jm, variables=v, bf16=True).infer({"image": x})
    ref32 = JaxPredictor(jm, variables=v).infer({"image": x})
    out = Predictor(tm, device="cpu", bf16=True).infer({"image": x})
    for key in ("stage1", "enhanced"):
        assert out[key].dtype == torch.float32
        close(out[key].numpy(), ref[key], TOL_BF16)
        gap = np.abs(out[key].numpy() - np.asarray(ref[key])).mean()
        assert gap <= 2 * np.abs(np.asarray(ref[key]) - np.asarray(ref32[key])).mean(), key


@pytest.mark.parametrize("depth", [2, 3, 5])
def test_bridge_maps_every_param_at_each_depth(depth):
    """Every JAX param lands on a port param of its layout (strict load),
    and the two forwards agree."""
    kw = {"num_channels": 4, "depth": depth, "in_pos_right": depth - 1}
    jm, v, tm = weights(kw, seed=depth)
    flat = flat_params(v)
    assert len(flat) == len(tm.module.state_dict())
    x = frames((2, 32, 48, 3), seed=depth)
    ref = jax.jit(jm.apply)(v, {"image": jnp.asarray(x)})
    with torch.no_grad():
        out = tm.apply({"image": torch.from_numpy(x)})
    for key in ("stage1", "enhanced"):
        close(out[key].numpy(), ref[key])


def test_loads_the_released_naming():
    """An independent torch HINet (published architecture) under the
    released names loads strictly and gives its outputs."""
    torch.manual_seed(3)
    ref_net = TorchHINet(c=8, depth=3).eval()
    with torch.no_grad():
        for p in ref_net.parameters():
            p.add_(torch.empty_like(p).uniform_(-0.05, 0.05))
    state = {k.replace(".down.", ".downsample."): t for k, t in ref_net.state_dict().items()}
    tm = build_model("hinet_re", device="cpu", num_channels=8, depth=3, in_pos_right=2)
    tm.module.load_state_dict(state, strict=True)
    x = frames((1, 32, 32, 3), seed=2)
    with torch.no_grad():
        y2, y1 = ref_net(torch.from_numpy(x).permute(0, 3, 1, 2))
        out = tm.apply({"image": torch.from_numpy(x)})
    close(out["enhanced"].numpy(), y2.permute(0, 2, 3, 1).numpy())
    close(out["stage1"].numpy(), y1.permute(0, 2, 3, 1).numpy())


def test_predictor_pads_to_16_and_matches_jax(tiny):
    jm, v, tm = tiny
    x = frames((2, 37, 45, 3), seed=3)
    ref = JaxPredictor(jm, variables=v).infer({"image": x})
    out = Predictor(tm, device="cpu").infer({"image": x})
    assert tm.size_divisor == 16
    for key in ("stage1", "enhanced"):
        close(out[key].numpy(), ref[key])


def test_tiled_predictor_matches_jax(tiny):
    """hinet_tiny_tiled's spec on a 70x90 frame (padded to 80x96): 3 x 4
    tiles of 32 with overlap 8, each normalised by its own statistics."""
    jm, v, tm = tiny
    x = frames((1, 70, 90, 3), seed=4)
    ref = JaxPredictor(jm, variables=v, tile=TILE, tile_blend="uniform").infer({"image": x})
    out = Predictor(tm, tile=TILE, tile_blend="uniform", device="cpu").infer({"image": x})
    close(out["enhanced"].numpy(), ref["enhanced"])
    whole = Predictor(tm, device="cpu").infer({"image": x})["enhanced"]
    assert (out["enhanced"] - whole).abs().max().item() > 1e-3   # the tiles' own statistics


@pytest.mark.parametrize("tile", [False, True])
def test_predict_cli_matches_jax(tiny, tmp_path, monkeypatch, tile):
    """The CLI builds the registered model at its default width; the tiny
    HINet stands in for it here."""
    from enhax.train.checkpoints import save_params_npz
    from enhax_torch.cli import predict as cli

    jm, v, _ = tiny
    weights_path = tmp_path / "w.npz"
    save_params_npz(weights_path, v)
    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(6)
    for name, hw in (("a.png", (37, 45)), ("b.png", (50, 66))):
        cv2.imwrite(str(data / name), (rng.uniform(0, 1, (*hw, 3)) * 255).astype(np.uint8))
    real_build = build_model
    monkeypatch.setattr("enhax_torch.models.base.build_model",
                        lambda name, **kw: real_build(name, **TINY, **kw))
    flags = ["--tile", "32", "--tile-overlap", "8", "--tile-blend", "uniform"] if tile else []
    cli.main(["--model", "hinet_re", "--data", str(data), "--save-dir", str(tmp_path / "out"),
              "--weights", str(weights_path), "--device", "cpu", *flags])
    for name in ("a.png", "b.png"):
        ours = cv2.imread(str(tmp_path / "out" / name)).astype(int)
        img = cv2.imread(str(data / name))[..., ::-1].astype(np.float32) / 255.0
        pred = JaxPredictor(jm, variables=v, tile=TILE if tile else None, tile_blend="uniform")
        ref = pred.infer({"image": img})["enhanced"][0]
        ref = np.clip(np.round(np.asarray(ref) * 255), 0, 255)[..., ::-1].astype(int)
        assert ours.shape == ref.shape == img.shape
        assert np.abs(ours - ref).max() <= 1, name


def test_restart_schedule_matches_jax_at_its_boundaries():
    spec = load_config(GOPRO)["optimizer_cfg"]["lr_scheduler"]["scheduler"]
    kw = {k: v for k, v in spec.items() if k != "name"}
    ref = JAX_LR_SCHEDULERS.build(spec["name"], base_lr=2e-4, **kw)
    ours = build_schedule(2e-4, spec)
    for step in (0, 1, 50, 99, 100, 101, 150, 199, 200, 201, 260):
        assert abs(ours(step) - float(ref(step))) <= 1e-6 * 2e-4, step
    # the second period restarts at restart_weights[1] = 0.5 of the first
    eta = spec["eta_min"]
    assert abs((ours(101) - eta) - 0.5 * (ours(1) - eta)) <= 1e-12 and ours(100) == eta


def test_gopro_train_step_matches_jax(tiny):
    """One float32 step of configs/hinet_gopro.py's Adam (lr 2e-4, the
    restart schedule): the loss, every gradient and every param after it."""
    jm, v, _ = tiny
    opt_cfg = load_config(GOPRO)["optimizer_cfg"]
    rng = np.random.default_rng(7)
    ref_img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    img = np.clip(ref_img + rng.normal(0, 0.1, ref_img.shape), 0, 1).astype(np.float32)
    batch = {"image": img, "ref_image": ref_img}
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(lambda p: jm.forward_loss(p, jb)[0]))(v)
    tx = jax_build_optimizer(opt_cfg)
    step = jax_make_train_step(jm, tx, donate=False)
    state, mets = step(JaxTrainState(step=0, params=v, opt_state=tx.init(v), ema=None), jb,
                       jax.random.PRNGKey(0))
    grads_ref = jax_to_torch_state_dict("hinet_re", flat_params(grads_ref))
    params_ref = jax_to_torch_state_dict("hinet_re", flat_params(state.params))

    _, _, tm = weights(TINY)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    loss, _ = tm.forward_loss(tb)
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= TOL_STEP_LOSS * max(1.0, abs(float(loss_ref)))
    for k, p in tm.module.named_parameters():
        close(p.grad.numpy(), grads_ref[k].numpy(), TOL_GRAD)
    tm.module.zero_grad(set_to_none=True)
    opt = build_optimizer(opt_cfg)
    port_step = make_train_step(tm, opt)
    port_state = TrainState(0, tm.module, opt.init(tm.module.parameters()))
    m = port_step(port_state, tb)
    assert abs(m["loss"].item() - float(mets["loss"])) <= TOL_STEP_LOSS * max(
        1.0, abs(float(mets["loss"])))
    assert abs(m["psnr"].item() - float(mets["psnr"])) <= TOL_STEP_LOSS * abs(float(mets["psnr"]))
    lr = opt_cfg["optimizer"]["lr"]
    for k, t in tm.module.state_dict().items():
        d = (t - params_ref[k]).abs()
        if k in CANCELLED:
            # the first half of these biases is cancelled by the instance
            # norm's mean: its gradient is 0 in exact arithmetic and float32
            # noise in either package (within TOL_GRAD of 0), and
            # Adam's first step moves each entry lr along the noise's sign
            half = d.shape[0] // 2
            assert float(grads_ref[k][:half].abs().max()) <= TOL_GRAD, k
            assert float(d[:half].max()) <= 2 * lr * 1.001, k
            d = d[half:]
        assert float(d.max()) <= TOL_STEP_PARAM, k
