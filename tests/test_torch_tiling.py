"""Port parity: overlap-tiled inference against the JAX package, on the CPU.

``tiled_apply``, ``tiled_apply_batched`` and ``tiled_apply_frames`` with a
shape-preserving nonlinear function, in both blends, including the chunk
padding and the full-height strip; the tiled ``Predictor`` and the predict
CLI's ``--tile`` on a tiny Restormer with one set of weights in both
packages. Tolerances: 1e-5 for the tiling, 3e-5 for a model.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer import Predictor as JaxPredictor
from enhax.infer import tiling as jt
from enhax.models.base import build_model as jax_build_model
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.infer import tiling as tt
from enhax_torch.models.base import build_model

TOL = 1e-5
TOL_MODEL = 3e-5
TINY = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "heads": (1, 1, 2, 2)}


def fn_torch(x):
    return x * 0.5 + x ** 2 * 0.1


def fn_jax(x):
    return x * 0.5 + x ** 2 * 0.1


def frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def close(out, ref, tol=TOL):
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("full, tile, stride", [(70, 32, 24), (32, 32, 24), (20, 32, 8),
                                                (90, 40, 1), (100, 33, 17)])
def test_tile_starts_match_jax(full, tile, stride):
    assert tt._tile_starts(full, tile, stride) == jt._tile_starts(full, tile, stride)


@pytest.mark.parametrize("blend", ["hann", "uniform"])
def test_blend_windows_match_jax(blend):
    close(tt._blend_window(13, 21, blend), jt._blend_window(13, 21, blend), 0)
    with pytest.raises(ValueError, match="blend"):
        tt._blend_window(4, 4, "cosine")


def test_best_chunk_matches_jax():
    for total in range(1, 200):
        for chunk in (1, 3, 6, 8, 16):
            assert tt._best_chunk(total, chunk) == jt._best_chunk(total, chunk), (total, chunk)


@pytest.mark.parametrize("blend", ["hann", "uniform"])
@pytest.mark.parametrize("shape, tile, overlap", [((2, 70, 90, 3), (32, 32), 8),
                                                  ((1, 40, 56, 3), (16, 24), 4),
                                                  ((1, 20, 24, 3), (32, 32), 8)])
def test_tiled_apply_matches_jax(blend, shape, tile, overlap):
    """The last case is one tile clamped to the whole image."""
    x = frames(shape)
    ref = jt.tiled_apply(fn_jax, jnp.asarray(x), tile=tile, overlap=overlap, blend=blend)
    close(tt.tiled_apply(fn_torch, torch.from_numpy(x), tile=tile, overlap=overlap,
                         blend=blend), ref)


@pytest.mark.parametrize("blend", ["hann", "uniform"])
@pytest.mark.parametrize("chunk", [5, 7, 9])
def test_tiled_apply_batched_matches_jax(blend, chunk):
    """4 x 6 = 24 tiles: chunks of 5 (-> 4), 7 (-> 6) and 9 (pad 3)."""
    x = frames((1, 70, 90, 3), seed=1)
    ref = jt.tiled_apply_batched(fn_jax, jnp.asarray(x), tile=(24, 24), overlap=8,
                                 chunk=chunk, blend=blend)
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return fn_torch(t)

    out = tt.tiled_apply_batched(fn, torch.from_numpy(x), tile=(24, 24), overlap=8,
                                 chunk=chunk, blend=blend)
    close(out, ref)
    used = jt._best_chunk(24, chunk)
    assert set(calls) == {used} and sum(calls) == -(-24 // used) * used
    with pytest.raises(ValueError, match="single image"):
        tt.tiled_apply_batched(fn_torch, torch.zeros(2, 8, 8, 3))


@pytest.mark.parametrize("blend", ["hann", "uniform"])
def test_tiled_apply_frames_matches_jax_and_per_frame(blend):
    """Three frames' tiles in chunks of 5 (the last padded), against the
    JAX function and against per-frame tiled_apply."""
    x = frames((3, 40, 56, 3), seed=2)
    ref = jt.tiled_apply_frames(fn_jax, jnp.asarray(x), tile=(16, 16), overlap=4, chunk=5,
                                blend=blend)
    out = tt.tiled_apply_frames(fn_torch, torch.from_numpy(x), tile=(16, 16), overlap=4,
                                chunk=5, blend=blend)
    close(out, ref)
    for f in range(3):
        one = tt.tiled_apply(fn_torch, torch.from_numpy(x[f:f + 1]), tile=(16, 16),
                             overlap=4, blend=blend)
        close(out[f:f + 1], one.numpy())


def test_tiled_apply_frames_full_height_strips():
    """Rectangular tiles with th = H: no vertical overlap."""
    x = frames((3, 40, 56, 3), seed=3)
    ref = jt.tiled_apply_frames(fn_jax, jnp.asarray(x), tile=(40, 16), overlap=4, chunk=3)
    out = tt.tiled_apply_frames(fn_torch, torch.from_numpy(x), tile=(40, 16), overlap=4,
                                chunk=3)
    close(out, ref)
    for f in range(3):
        one = jt.tiled_apply(fn_jax, jnp.asarray(x[f:f + 1]), tile=(40, 16), overlap=4)
        close(out[f:f + 1], one)


# -- the tiled Predictor and the CLI on a tiny Restormer ---------------------------

def random_variables(jm, seed: int):
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 16, 16, 3))})
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name == "temperature":
            a = rng.uniform(0.5, 3.0, s.shape)
        elif name == "scale":
            a = 1 + rng.uniform(-0.3, 0.3, s.shape)
        elif name == "bias":
            a = rng.uniform(-0.2, 0.2, s.shape)
        else:
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, struct)


def flat_params(variables) -> dict:
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf)
    return flat


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build_model("restormer", **TINY)
    v = random_variables(jm, seed=0)
    tm = build_model("restormer", device="cpu", **TINY)
    tm.module.load_state_dict(jax_to_torch_state_dict("restormer", flat_params(v)), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("blend", ["hann", "uniform"])
def test_tiled_predictor_matches_jax(tiny, blend):
    """Two 37x45 frames pad to 40x48: 2 x 3 tiles of 24 with overlap 8."""
    jm, v, tm = tiny
    x = frames((2, 37, 45, 3), seed=4)
    ref = JaxPredictor(jm, variables=v, tile=(24, 24, 8), tile_blend=blend).infer({"image": x})
    out = Predictor(tm, tile=(24, 24, 8), tile_blend=blend, device="cpu").infer({"image": x})
    assert out["time"] >= 0
    close(out["enhanced"], ref["enhanced"], TOL_MODEL)


def test_tiled_predictor_bf16_returns_float32(tiny):
    """bf16 inside the model, the blend in float32: near the float32 run."""
    _, _, tm = tiny
    x = frames((1, 24, 32, 3), seed=5)
    ref = Predictor(tm, tile=(24, 24, 8), device="cpu").infer({"image": x})["enhanced"]
    out = Predictor(tm, tile=(24, 24, 8), bf16=True, device="cpu").infer({"image": x})
    tm.to(dtype=torch.float32)   # the fixture's model is shared
    out = out["enhanced"]
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 24, 32, 3)
    err = (out - ref).abs().max().item()
    assert torch.isfinite(out).all() and err < 0.1 * ref.abs().max().item()


def test_tiled_predictor_refuses_a_scaling_model(tiny):
    import dataclasses
    _, _, tm = tiny
    pred = Predictor(dataclasses.replace(tm, scale=2), tile=(24, 24, 8), device="cpu")
    with pytest.raises(ValueError, match="shape-preserving"):
        pred.infer({"image": frames((16, 16, 3))})


def test_predict_cli_tiled_matches_jax(tiny, tmp_path, monkeypatch):
    """The CLI builds the registered model at its default width; the tiny
    Restormer stands in for it here."""
    from enhax.train.checkpoints import save_params_npz
    from enhax_torch.cli import predict as cli

    jm, v, _ = tiny
    weights = tmp_path / "w.npz"
    save_params_npz(weights, v)
    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(6)
    cv2.imwrite(str(data / "a.png"), (rng.uniform(0, 1, (37, 45, 3)) * 255).astype(np.uint8))
    real_build = build_model
    monkeypatch.setattr("enhax_torch.models.base.build_model",
                        lambda name, **kw: real_build(name, **TINY, **kw))
    cli.main(["--model", "restormer", "--data", str(data), "--save-dir", str(tmp_path / "out"),
              "--weights", str(weights), "--device", "cpu", "--tile", "24",
              "--tile-overlap", "8", "--tile-blend", "uniform"])
    ours = cv2.imread(str(tmp_path / "out" / "a.png")).astype(int)
    img = cv2.imread(str(data / "a.png"))[..., ::-1].astype(np.float32) / 255.0
    ref = JaxPredictor(jm, variables=v, tile=(24, 24, 8),
                       tile_blend="uniform").infer({"image": img})["enhanced"][0]
    ref = np.clip(np.round(np.asarray(ref) * 255), 0, 255)[..., ::-1].astype(int)
    assert ours.shape == ref.shape == (37, 45, 3)
    assert np.abs(ours - ref).max() <= 1
