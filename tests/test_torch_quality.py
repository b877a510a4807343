"""The quality chains (``QUALITY.json``'s nine rows) in the port against the
JAX package's, on the CPU.

Both packages start each chain from the JAX package's init
(``model.init`` at ``PRNGKey(0)``, as its trainer and Predictor draw it;
the port draws it with numpy, ``convert.jax_init``, which
``test_jax_init_draws_the_jax_package_init`` holds to flax's own draw
within 4 float32 ulps of max|value|). Each trained chain trains 3 one-batch
epochs in each (``run/make_quality.py::run_one`` and
``enhax_torch.quality.run_one``); both predict CLIs and both metric CLIs
then run as the chains run them. The instance chains fit 3 steps an image
(``instance_steps=3``); the tiled chain and the video chain reuse
``hinet_tiny``'s checkpoint in each package. Per row: the port's chain
writes the JAX CLI's images within 1 uint8 level (the video's decoded
frames within 1 level on average: the codec is lossy), and its metric CLI's
scores are the JAX metric CLI's within 1e-3 dB PSNR and 1e-4 SSIM
(unrounded); for ``hinet_tiny`` the port's predict CLI on the JAX run's own
checkpoint, bridged by ``tools/jax_ckpt_to_torch.py``, writes them within 1
level too. The instance chains are held on their fits and composition
(``test_instance_chain_matches_jax``).

The full-length chains (60/120 epochs) from the JAX init against
``QUALITY.json``'s rows, within its own tolerances (0.5 dB, 0.02 SSIM), are
``test_full_chains_match_the_record`` under the slow marker. Over their
full length the chains are chaotic (``tools/quality_spread.py``: the JAX
package's own ``hinet_tiny`` moves 29.80 -> 28.46 / 31.43 dB and
``uformer_tiny`` 0.4456 -> 0.4421 / 0.4789 SSIM under a 1e-7 change of its
init, and its ``uformer_tiny`` row on another x86 CPU, 0.4456, is 0.04 from the
record's 0.4863), so that test reads how far a machine's rows drift, not
the port against the JAX package; ``colie_instance`` differs by design
(ROADMAP 3.9).
"""

import json
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.cli.metric import measure_metric as jax_measure_metric
from enhax.models.base import build_model as jax_build_model
from enhax_torch import quality as q
from enhax_torch.cli.metric import measure_metric
from enhax_torch.cli.predict import predict
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from torch_train_parity import flat_params

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "run"))
sys.path.insert(0, str(REPO / "tools"))
try:
    import make_quality as jq
    from jax_ckpt_to_torch import convert
finally:
    del sys.path[:2]

STEPS = 3
TRAINED = {row[0]: row for row in q.MODELS_UNDER_TEST}
EXTRA = dict(q.EXTRA_CHAINS)


def jax_init(model_name, model_cfg, batch):
    jm = jax_build_model(model_name, **model_cfg)
    return jax.jit(jm.init)(jax.random.PRNGKey(0), {k: jnp.asarray(a) for k, a in batch.items()})


def jax_run_one(name, model_name, cfg, supervised, epochs, lr, out_root):
    """``run/make_quality.py::run_one``'s train and predict, the trainer's
    state built around a jitted init (its own draws the same params
    eagerly, slowly)."""
    from enhax.cli.predict import predict as jax_predict
    from enhax.train import Trainer as JaxTrainer
    jm = jax_build_model(model_name, **cfg)
    batch = q.training_batch(supervised, jm.size_divisor)
    ckpt = Path(out_root) / name / "ckpt"
    tr = JaxTrainer(jm, {"optimizer": {"name": "adam", "lr": lr},
                         "grad_clip_norm": 0.1 if not supervised else None},
                    max_epochs=epochs, seed=0, ckpt_dir=ckpt, log_every_n_steps=10**6)
    state = tr.init_state(batch, params=jax_init(model_name, cfg, batch))
    tr.fit(lambda: [batch], state=state, resume=False)
    jax_predict({"model": model_name, "model_cfg": cfg, "data": str(q.GOLDEN / "image"),
                 "weights": str(ckpt / "last"), "save_dir": str(Path(out_root) / name / "pred"),
                 "seed": 0})


def close_images(a, b, mean_only=False):
    fa = sorted(p.relative_to(a) for p in Path(a).rglob("*.png"))
    assert fa == sorted(p.relative_to(b) for p in Path(b).rglob("*.png")) and fa
    for rel in fa:
        x = cv2.imread(str(Path(a) / rel)).astype(int)
        y = cv2.imread(str(Path(b) / rel)).astype(int)
        d = np.abs(x - y)
        assert x.shape == y.shape and (d.mean() if mean_only else d.max()) <= 1, rel


def close_scores(pred, jpred, target):
    args = {"input": str(pred), "target": str(target), "metric": ["psnr", "ssim"]}
    ours = measure_metric({**args, "device": "cpu"})
    ref = jax_measure_metric({**args, "input": str(jpred)})
    assert abs(ours["psnr"] - float(ref["psnr"])) <= 1e-3, (ours, ref)
    assert abs(ours["ssim"] - float(ref["ssim"])) <= 1e-4, (ours, ref)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")


@pytest.mark.parametrize("chain", ["zero_dce_re", "hinet_tiny", "nafnet_tiny", "colie_instance",
                                   "zero_mie_ms_instance"])
def test_jax_init_draws_the_jax_package_init(chain):
    """``jax_init_state_dict`` against flax's ``model.init(PRNGKey(0), ...)``
    at the example the chain inits at, through the bridge: every param
    within 4 float32 ulps of its max|value|. (Restormer's and Uformer's
    inits are held by their trained chains, whose images match JAX's.)"""
    from enhax_torch.convert.jax_init import jax_init_state_dict, load_spec
    spec = load_spec(chain)
    ref = jax_to_torch_state_dict(spec["model"], flat_params(jax_init(
        spec["model"], spec["model_cfg"], {"image": np.zeros(spec["example"], np.float32)})))
    ours = jax_init_state_dict(chain)
    assert set(ours) == set(ref)
    for k, t in ours.items():
        scale = max(float(ref[k].abs().max()), 1e-30)
        assert float((t - ref[k]).abs().max()) <= 4 * np.finfo(np.float32).eps * scale, k


@pytest.fixture(scope="module")
def trained(roots):
    """Each trained chain (and so ``hinet_tiny``'s checkpoint) in both
    packages, once, both from the JAX init."""
    jroot, proot = roots
    done = {}

    def run(name):
        if name not in done:
            _, model_name, cfg, sup, _, lr = TRAINED[name]
            jax_run_one(name, model_name, cfg, sup, STEPS, lr, jroot)
            q.run_one(name, model_name, cfg, sup, STEPS, lr, proot, "cpu")
            done[name] = True
    return run


@pytest.mark.parametrize("name", list(TRAINED))
def test_trained_chain_matches_jax(roots, trained, name, tmp_path):
    jroot, proot = roots
    trained(name)
    _, model_name, cfg, *_ = TRAINED[name]
    close_images(proot / name / "pred", jroot / name / "pred")
    close_scores(proot / name / "pred", jroot / name / "pred", q.GOLDEN / "ref")
    if name != "hinet_tiny":
        return
    # the port's CLI on the JAX run's own checkpoint, through the bridge
    convert(jroot / name / "ckpt" / "last", tmp_path / "ckpt",
            model_name, model_cfg=cfg,
            optimizer_cfg={"optimizer": {"name": "adam", "lr": TRAINED[name][5]},
                           "grad_clip_norm": None if TRAINED[name][3] else 0.1})
    out = predict({"model": model_name, "model_cfg": cfg, "data": str(q.GOLDEN / "image"),
                   "weights": str(tmp_path / "ckpt"), "save_dir": str(tmp_path / "pred"),
                   "device": "cpu"})
    close_images(out, jroot / name / "pred")


# the instance chains: their model, the low-resolution maps their fit
# yields, and how each model composes its output from them (the guided
# filter's radius, CoLIE's normalisation by the max)
INSTANCE = {
    "colie_instance": ("colie_re", ("illu_lr", "image_v_lr", "image_v_fixed_lr"),
                       ("image_v_lr", "image_v_fixed_lr"), 1, True),
    "zero_mie_ms_instance": ("zero_mie_ms", ("illu_lr", "illu_lr2", "image_lr", "enhanced_lr"),
                             ("image_lr", "enhanced_lr"), 3, False),
}


@pytest.mark.parametrize("name", list(INSTANCE))
def test_instance_chain_matches_jax(name):
    """The instance chains' 3-step fits through both packages' Predictors:
    the fitted low-resolution maps within 1e-4 x max(1, max|ref|) and
    fit_loss within 1e-3 of its value; then the output composed from the
    JAX fit's maps by the port's ops (guided filter, HSV) against the JAX
    package's own composition of them with its guided filter in float64,
    within 1e-5. The composition is ill-conditioned on these inputs (window
    variances of the upsampled V, ~1e-9, under eps = 1e-8): in float32 the
    JAX package's filter is cancellation noise (CoLIE's output moves 0.86
    from its float64 result, Zero-MIE-MS's 0.26), and maps 1e-5 apart give
    outputs far apart in any precision, so neither CLI's images are a
    reference for the other's here; the port's window moments are float64
    (9e-7 from JAX's float64 filter on CoLIE's maps)."""
    from enhax.infer import Predictor as JaxPredictor
    from enhax.ops.color import hsv_to_rgb, rgb_to_hsv
    from enhax.ops.filtering import fast_guided_filter_bicubic
    from enhax_torch.convert.jax_init import jax_init_state_dict
    from enhax_torch.infer import Predictor
    from enhax_torch.models.base import build_model
    model, maps, gf_in, radius, by_max = INSTANCE[name]
    cfg = {**EXTRA[name]["model_cfg"], "instance_steps": STEPS}
    img = q.golden("image")[:1]
    jout = JaxPredictor(jax_build_model(model, **cfg))({"image": img})
    tm = build_model(model, device="cpu", **cfg)
    tm.module.load_state_dict(jax_init_state_dict(name))
    tout = Predictor(tm, device="cpu")({"image": img})
    for k in maps:
        ref = np.asarray(jout[k])
        assert np.abs(tout[k].numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max()), k
    assert abs(float(tout["fit_loss"]) - float(jout["fit_loss"])) <= 1e-3 * abs(
        float(jout["fit_loss"]))
    with jax.enable_x64(True):
        hsv = rgb_to_hsv(jnp.asarray(img, jnp.float64))
        lr = [jnp.asarray(np.asarray(jout[k]), jnp.float64) for k in gf_in]
        v = jnp.clip(fast_guided_filter_bicubic(*lr, hsv[..., 2:3], radius=radius), 0.0, 1.0)
        rgb = hsv_to_rgb(jnp.concatenate([hsv[..., :2], v], axis=-1))
        ref = np.asarray(rgb / rgb.max() if by_max else rgb)
    from enhax_torch.ops import color, filtering
    thsv = color.rgb_to_hsv(torch.from_numpy(img))
    tv = filtering.fast_guided_filter_bicubic(
        *(torch.from_numpy(np.asarray(jout[k])) for k in gf_in), thsv[..., 2:3],
        radius=radius).clamp(0.0, 1.0)
    trgb = color.hsv_to_rgb(torch.cat([thsv[..., :2], tv], dim=-1))
    ours = (trgb / trgb.max() if by_max else trgb).numpy()
    assert np.abs(ours - ref).max() <= 1e-5
    assert tout["enhanced"].shape == ref.shape and torch.isfinite(tout["enhanced"]).all()


def test_tiled_chain_matches_jax(roots, trained):
    jroot, proot = roots
    trained("hinet_tiny")
    name = "hinet_tiny_tiled"
    jq.run_chain(name, EXTRA[name], jroot)
    q.run_chain(name, EXTRA[name], proot, "cpu")
    close_images(proot / name / "pred", jroot / name / "pred")
    close_scores(proot / name / "pred", jroot / name / "pred", q.GOLDEN / "ref")


def test_video_chain_matches_jax(roots, trained):
    jroot, proot = roots
    trained("hinet_tiny")
    jrow = jq.run_video_chain("video_chain", jroot, {})
    prow = q.run_video_chain("video_chain", proot, "cpu")
    assert prow["frames"] == jrow["frames"] == 8
    close_images(proot / "video_chain" / "frames", jroot / "video_chain" / "frames",
                 mean_only=True)
    assert abs(prow["psnr"] - jrow["psnr"]) <= 0.05 and abs(prow["ssim"] - jrow["ssim"]) <= 1e-3


@pytest.mark.slow
def test_full_chains_match_the_record(tmp_path):
    """Every chain at full length from the JAX package's init, against
    QUALITY.json's rows within the artifact's tolerances (0.5 dB, 0.02
    SSIM)."""
    record = json.loads((REPO / "QUALITY.json").read_text())["results"]
    rows = q.run_all(tmp_path, "cpu")
    for name, row in rows.items():
        assert abs(row["psnr"] - record[name]["psnr"]) < 0.5, (name, row, record[name])
        assert abs(row["ssim"] - record[name]["ssim"]) < 0.02, (name, row, record[name])
