"""Port parity: Predictor and the predict CLI against the JAX package.

One set of JAX weights goes through ``jax_to_torch_state_dict`` into the
port; everything runs on the CPU in float32.
"""

import argparse
import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
NAME = "zero_dce++_re"
KW = {"scale_factor": 4.0, "num_channels": 8}


def flat_params(variables) -> dict:
    """The flat-key format of enhax.train.checkpoints.save_params_npz."""
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf)
    return flat


@pytest.fixture(scope="module")
def pair():
    """(jax model, its variables, the port's model with the same weights)."""
    jm = jax_build_model(NAME, **KW)
    variables = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    tm = build_model(NAME, device="cpu", **KW)
    tm.module.load_state_dict(jax_to_torch_state_dict(NAME, flat_params(variables)))
    return jm, variables, tm


def _close(out: dict, ref: dict):
    for key in ("enhanced", "adjust"):
        assert tuple(out[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL,
                                   err_msg=key)
    assert out["time"] >= 0


@pytest.mark.parametrize("shape, buckets", [
    ((37, 50, 3), None),          # reflect pad to 64x64, then crop
    ((1, 37, 50, 3), (48, 96)),   # 64x64, then up to the 96 bucket
    ((10, 12, 3), None),          # pad 22 > H-1: reflect what fits, edge-extend
])
def test_predictor_infer_matches_jax(pair, rng, shape, buckets):
    jm, variables, tm = pair
    x = rng.uniform(0, 0.4, shape).astype(np.float32)
    ref = JaxPredictor(jm, variables=variables, bucket_sizes=buckets).infer({"image": x})
    out = Predictor(tm, bucket_sizes=buckets, device="cpu").infer(
        {"image": x, "meta": {"name": "x.png"}})
    _close(out, ref)


def test_predictor_takes_float64_like_jax(pair, rng):
    jm, variables, tm = pair
    x = rng.uniform(0, 0.4, (1, 32, 32, 3))
    ref = JaxPredictor(jm, variables=variables).infer({"image": x})
    out = Predictor(tm, device="cpu").infer({"image": x})
    assert out["enhanced"].dtype == torch.float32
    _close(out, ref)


def test_predictor_resize_to_image_size_matches_jax(pair, rng):
    jm, variables, tm = pair
    x = rng.uniform(0, 0.4, (1, 30, 44, 3)).astype(np.float32)
    ref = JaxPredictor(jm, variables=variables, image_size=(32, 32),
                       resize=True).infer({"image": x})
    out = Predictor(tm, image_size=(32, 32), resize=True, device="cpu").infer({"image": x})
    assert tuple(out["enhanced"].shape) == (1, 30, 44, 3)
    np.testing.assert_allclose(out["enhanced"].numpy(), np.asarray(ref["enhanced"]),
                               atol=TOL)


def test_predict_iter_groups_like_jax(pair, rng):
    jm, variables, tm = pair
    items = [{"image": rng.uniform(0, 0.4, (20, 24, 3)).astype(np.float32),
              "meta": {"name": f"{i}.png"}} for i in range(3)]
    items.append({"image": rng.uniform(0, 0.4, (30, 20, 3)).astype(np.float32),
                  "meta": {"name": "odd.png"}})
    ref = list(JaxPredictor(jm, variables=variables).predict_iter(items, batch_size=8))
    out = list(Predictor(tm, device="cpu").predict_iter(items, batch_size=8))
    assert [len(m) for _, m in out] == [len(m) for _, m in ref] == [3, 1]
    for (o, om), (r, rm) in zip(out, ref):
        assert om == rm
        _close(o, r)


@pytest.mark.parametrize("kwargs, item", [
    ({"mesh": object(), "tile": (64, 64, 8)}, "item 1.14"),
    ({"mesh": object()}, "item 1.14"),
    ({"spatial": True}, "item 1.14"),
])
def test_predictor_unported_options_raise(pair, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        Predictor(pair[2], device="cpu", **kwargs)


def test_predictor_instance_models_raise(pair):
    """An instance model is served by a fit to each image (ported: the fit
    runs ``model.forward_loss``); one without a loss raises at the request,
    as the JAX Predictor's fit does."""
    instance = dataclasses.replace(pair[2], instance_steps=100, loss_fn=None)
    pred = Predictor(instance, device="cpu")
    with pytest.raises(ValueError, match="has no loss"):
        pred({"image": np.zeros((8, 8, 3), np.float32)})


def test_predictor_bf16_casts_params_and_returns_float32(rng):
    tm = build_model(NAME, device="cpu", **KW)
    x = rng.uniform(0, 0.4, (1, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        ref = tm.apply({"image": torch.from_numpy(x)})["enhanced"]
    pred = Predictor(tm, bf16=True, device="cpu")
    out = pred.infer({"image": x})["enhanced"]
    # the Predictor serves a bf16 copy; the caller's model keeps float32
    assert pred.model.dtype == torch.bfloat16 and tm.dtype == torch.float32
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() < 2e-2


def test_bf16_predictor_leaves_the_callers_model_float32(rng):
    """A bf16 Predictor and then a float32 one on the same model both serve,
    as the JAX pair does (the JAX engine casts a copy of the variables)."""
    tm = build_model(NAME, device="cpu", **KW)
    fresh = build_model(NAME, device="cpu", **KW)
    fresh.module.load_state_dict(tm.module.state_dict())
    x = rng.uniform(0, 0.4, (1, 32, 32, 3)).astype(np.float32)
    half = Predictor(tm, bf16=True, device="cpu").infer({"image": x})["enhanced"]
    out = Predictor(tm, device="cpu").infer({"image": x})["enhanced"]
    ref = Predictor(fresh, device="cpu").infer({"image": x})["enhanced"]
    assert all(t.dtype == torch.float32 for t in tm.module.parameters())
    assert torch.isfinite(half).all() and half.dtype == torch.float32
    assert out.dtype == torch.float32 and torch.equal(out, ref)


def _nested_checkpoints():
    """Released-checkpoint nestings with prefixes, each beside the flat
    state dict it should unwrap to."""
    rng = np.random.default_rng(3)
    flat = {"conv.weight": torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32)),
            "conv.bias": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}
    ema = {k: v + 1 for k, v in flat.items()}
    prefixed = {f"module.{k}": v for k, v in ema.items()}
    return [
        (flat, flat),
        ({"state_dict": {f"_orig_mod.{k}": v for k, v in flat.items()}}, flat),
        ({"params_ema": prefixed, "params": flat}, ema),   # params_ema first
        ({"params": {f"module.{k}": v for k, v in flat.items()}}, flat),
        ({"model": flat, "epoch": 3}, flat),
        ({"model_state_dict": flat, "optimizer": {"lr": 1e-3}}, flat),
        ({"net": flat}, flat),
    ]


@pytest.mark.parametrize("case", range(7))
def test_unwrap_state_dict_matches_jax(case):
    from enhax.convert.torch_weights import unwrap_state_dict as jax_unwrap
    from enhax_torch.convert.torch_weights import unwrap_state_dict
    ckpt, want = _nested_checkpoints()[case]
    ours, ref = unwrap_state_dict(ckpt), jax_unwrap(ckpt)
    assert list(ours) == list(ref) == list(want)
    for k in want:
        assert torch.equal(ours[k], ref[k]) and torch.equal(ours[k], want[k])


def test_read_torch_checkpoint_falls_back_to_a_full_unpickle(tmp_path, capsys):
    from enhax_torch.convert.torch_weights import read_torch_checkpoint
    path = tmp_path / "legacy.ckpt"
    torch.save({"params": {"w": torch.ones(2)}, "args": argparse.Namespace(lr=1e-3)}, path)
    state = read_torch_checkpoint(path)
    assert list(state) == ["w"] and torch.equal(state["w"], torch.ones(2))
    assert "not weights-only" in capsys.readouterr().out


def test_predict_cli_loads_a_nested_pth_as_the_flat_pt(tmp_path):
    """The predict CLI on a BasicSR-style release ({"params_ema", "params"},
    DataParallel prefixes) gives what it gives on the flat state dict."""
    from enhax_torch.cli.predict import main
    rng = np.random.default_rng(4)
    data = tmp_path / "imgs"
    data.mkdir()
    cv2.imwrite(str(data / "a.png"), (rng.uniform(0, 0.3, (20, 24, 3)) * 255).astype(np.uint8))
    tm = build_model("zero_dce++_re", device="cpu", seed=5, scale_factor=2.0)
    flat = tm.module.state_dict()
    torch.save(flat, tmp_path / "flat.pt")
    torch.save({"params_ema": {f"module.{k}": v for k, v in flat.items()},
                "params": {f"module.{k}": torch.zeros_like(v) for k, v in flat.items()}},
               tmp_path / "release.pth")
    for name in ("flat.pt", "release.pth"):
        main(["--model", "zero_dce++_re", "--data", str(data), "--save-dir",
              str(tmp_path / f"out_{name}"), "--weights", str(tmp_path / name), "--device",
              "cpu"])
    a = cv2.imread(str(tmp_path / "out_flat.pt" / "a.png"))
    b = cv2.imread(str(tmp_path / "out_release.pth" / "a.png"))
    assert a is not None and a.shape == (20, 24, 3) and np.array_equal(a, b)


def test_predict_cli_matches_jax_cli(tmp_path):
    from enhax.cli.predict import main as jax_main
    from enhax.train.checkpoints import save_params_npz
    from enhax_torch.cli.predict import main
    rng = np.random.default_rng(0)
    data = tmp_path / "imgs"
    data.mkdir()
    for name, hw in (("a.png", (20, 24)), ("b.png", (30, 28))):
        cv2.imwrite(str(data / name), (rng.uniform(0, 0.3, (*hw, 3)) * 255).astype(np.uint8))
    jm = jax_build_model("zero_dce++_re", scale_factor=2.0)
    variables = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    weights = tmp_path / "w.npz"
    save_params_npz(weights, variables)
    jax_main(["--model", "zero_dce++_re", "--data", str(data), "--save-dir",
              str(tmp_path / "jax"), "--weights", str(weights)])
    # the JAX CLI builds with default kwargs; so does the port's
    main(["--model", "zero_dce++_re", "--data", str(data), "--save-dir",
          str(tmp_path / "torch"), "--weights", str(weights), "--device", "cpu",
          "--batch-size", "2"])
    for name in ("a.png", "b.png"):
        ours = cv2.imread(str(tmp_path / "torch" / name)).astype(int)
        ref = cv2.imread(str(tmp_path / "jax" / name)).astype(int)
        assert ours.shape == ref.shape
        assert np.abs(ours - ref).max() <= 1, name


@pytest.mark.parametrize("flags, match", [
    (["--devices", "2"], "1.14"),
    (["--devices", "2", "--spatial"], "1.14"),
    (["--weights", "zoo:zero_dce/lol"], "1.15"),
])
def test_predict_cli_unported_sources_raise(tmp_path, flags, match):
    """Dataset names and videos are sources since the predict CLI's surface
    was ported; the mesh flags and zoo weights still raise, each naming its
    ROADMAP item."""
    from enhax_torch.cli.predict import main
    folder = tmp_path / "imgs"
    folder.mkdir()
    cv2.imwrite(str(folder / "a.png"), np.zeros((8, 8, 3), np.uint8))
    argv = ["--model", "zero_dce_re", "--data", str(folder), "--save-dir",
            str(tmp_path / "out"), "--device", "cpu", *flags]
    with pytest.raises(NotImplementedError, match=match):
        main(argv)
