"""Port parity on the CPU: PIE against the JAX package on 32x32 to 48x48, the
antialiased resize of DUAL's Mertens pyramid, and the parameter-free
models (LIME / DUAL and PIE) through ``Predictor`` and the predict CLI.

PIE within 1e-5 x max(1, max|ref|) of the JAX package's float32, and of
its float64 run (its constants cast, ``float64_constants``) within
max(1e-5, 4x the JAX package's own float32 gap) (``assert_witnessed``);
``resize(..., antialias=True)`` against ``jax.image.resize(..., "linear",
antialias=True)`` at sizes where halving rounds down, and back up without
the filter, within 1e-5; each model through ``Predictor`` (``Model.dtype``
float32 with no parameters) against the JAX package's forward within 1e-4
(LIME's host solve included), and through the predict CLI over a folder of
two images against the port's own forward within one uint8 step; the
registry entries (``dual`` an alias of ``lime``)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import classical as jc
from enhax_torch.cli import predict as predict_cli
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import classical as tc
from enhax_torch.ops.resize import resize
from test_torch_llie_zero_ref_classical import draw_images, witness64
from torch_family_parity import write_image
from torch_instance_parity import assert_close, assert_witnessed, rel_err
from torch_threads import capped_torch_threads  # noqa: F401


@pytest.mark.parametrize("h, w", [(32, 32), (33, 45), (48, 40)])
def test_pie_matches_jax(h, w):
    x = draw_images(2, h, w, seed=35)
    ref = jc.PIEModule().apply({}, jnp.asarray(x))["enhanced"]
    with torch.no_grad():
        out = tc.PIEModule()(torch.from_numpy(x))["enhanced"]
    assert_close(out, ref)
    assert_witnessed(out, ref, witness64(jc.PIEModule(), x))


@pytest.mark.parametrize("h, w, c", [(33, 47, 3), (5, 3, 3), (17, 2, 1), (64, 63, 3), (3, 3, 1),
                                     (2, 7, 3)])
def test_antialiased_halving_matches_jax(h, w, c):
    """Mertens' ``down``: H and W halved, rounding down (at least 1)."""
    x = np.random.default_rng(36).uniform(0, 1, (h, w, c)).astype(np.float32)
    size = (max(h // 2, 1), max(w // 2, 1))
    ref = jax.image.resize(jnp.asarray(x), size + (c,), "linear", antialias=True)
    out = resize(torch.from_numpy(x), size, antialias=True)
    assert tuple(out.shape) == size + (c,)
    assert_close(out, ref)
    # and up again without the filter (Mertens' ``up``)
    back = jax.image.resize(ref, (h, w, c), "linear", antialias=False)
    assert_close(resize(torch.from_numpy(np.asarray(ref)), (h, w)), back)


@pytest.mark.parametrize("name", ["lime", "dual", "pie"])
def test_parameter_free_models_serve_through_predictor(name):
    model = build_model(name, device="cpu")
    assert model.param_count() == 0 and model.dtype == torch.float32
    x = draw_images(1, 30, 34, seed=38)[0]
    out = Predictor(model, device="cpu")({"image": x})
    jm = jax_build_model(name)
    ref = jm.apply({}, {"image": jnp.asarray(x[None])})["enhanced"]
    assert tuple(out["enhanced"].shape) == (1, 30, 34, 3)
    assert rel_err(out["enhanced"], ref) <= 1e-4


@pytest.mark.parametrize("name", ["lime", "pie"])
def test_predict_cli_over_a_folder(tmp_path, name):
    rng = np.random.default_rng(39)
    for i in range(2):
        write_image(tmp_path / "in" / f"im{i}.png", rng.uniform(0.02, 0.4, (36, 28, 3)))
    save = predict_cli.predict(predict_cli.parse_predict_args(
        ["--model", name, "--data", str(tmp_path / "in"), "--save-dir", str(tmp_path / "out"),
         "--device", "cpu"]))
    model = build_model(name, device="cpu")
    for i in range(2):
        img = cv2.cvtColor(cv2.imread(str(tmp_path / "in" / f"im{i}.png")),
                           cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        got = cv2.cvtColor(cv2.imread(str(save / f"im{i}.png")), cv2.COLOR_BGR2RGB)
        with torch.no_grad():
            want = model.apply({"image": torch.from_numpy(img[None])})["enhanced"][0]
        want = (want.numpy() * 255.0).round().clip(0, 255)
        assert np.abs(got.astype(np.float32) - want).max() <= 1.0


@pytest.mark.parametrize("name", ["lime", "pie"])
def test_registry_entry_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps", "loss_fn"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    if name == "lime":
        assert build_model("dual", device="cpu").name == "lime"
        assert tm.module.dual and tm.module.exact
