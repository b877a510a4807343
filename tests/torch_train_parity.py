"""Shared by the port's training parity tests (``test_torch_train.py``,
``test_torch_data.py``): one tiny NAFNet's weights drawn with numpy, its
batches, the JAX package's train step and the port's on them, and the
weight bridge applied to JAX trees (params, gradients, EMA)."""

import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax.train.trainer import TrainState as JaxTrainState
from enhax.train.trainer import make_train_step as jax_make_train_step
from enhax.utils.config import load_config as jax_load_config
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.utils.config import load_config

TINY = {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1), "dec_blk_nums": (1, 1)}
SIDD = str(Path(__file__).resolve().parents[1] / "configs" / "nafnet_sidd.py")


def flat_params(tree) -> dict:
    """The flat-key format of enhax.train.checkpoints.save_params_npz."""
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf, np.float32)
    return flat


def to_port(name: str, tree, prefix: str = "") -> dict:
    """A JAX params-shaped tree (params, grads, EMA) in the port's layout."""
    flat = {prefix + k: v for k, v in flat_params(tree).items()}
    return jax_to_torch_state_dict(name, flat)


def draw_like(struct, rng):
    """Values of the params' structure drawn with numpy; beta and gamma
    nonzero (at their zero init the block is the identity)."""
    def draw(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name in ("beta", "gamma"):
            a = rng.uniform(-0.5, 0.5, s.shape)
        elif name == "scale":
            a = 1 + rng.uniform(-0.2, 0.2, s.shape)
        elif name == "bias":
            a = rng.uniform(-0.1, 0.1, s.shape)
        else:
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, struct)


def batches(n: int, seed: int = 11) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ref = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
        img = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
        out.append({"image": img, "ref_image": ref})
    return out


@functools.lru_cache(maxsize=None)
def sidd_optimizer_cfg() -> dict:
    """configs/nafnet_sidd.py's optimizer, read by the port's loader (which
    reads the file as the JAX package's does)."""
    cfg = load_config(SIDD)
    assert cfg == jax_load_config(SIDD)
    return cfg["optimizer_cfg"]


@functools.lru_cache(maxsize=None)
def tiny_weights():
    """The JAX model and its variables, drawn with numpy."""
    jm = jax_build_model("nafnet", **TINY)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 16, 16, 3))})
    return jm, draw_like(struct, np.random.default_rng(2))


@functools.lru_cache(maxsize=None)
def jax_run(remat: bool, precision):
    """Three steps of the JAX package's train step with the SIDD optimizer
    (EMA 0.999): the metrics of each step and the params and EMA after the
    first and the third, in the port's layout. One compile per variant."""
    jm, v = tiny_weights()
    tx = jax_build_optimizer(sidd_optimizer_cfg())
    step = jax_make_train_step(jm, tx, donate=False, remat=remat, precision=precision,
                               ema_decay=0.999)
    state = JaxTrainState(step=0, params=v, opt_state=tx.init(v),
                          ema=jax.tree_util.tree_map(jnp.copy, v))
    rng = jax.random.PRNGKey(0)
    mets, snaps = [], {}
    for i, b in enumerate(batches(3)):
        state, m = step(state, {k: jnp.asarray(a) for k, a in b.items()}, rng)
        mets.append({k: float(a) for k, a in m.items()})
        if i in (0, 2):
            snaps[i + 1] = (to_port("nafnet", state.params), to_port("nafnet", state.ema))
    return mets, snaps


def port_run(remat: bool, precision, fused: bool):
    """The same three steps through the port's ``make_train_step``."""
    _, v = tiny_weights()
    model = build_model("nafnet", device="cpu", **TINY)
    model.module.load_state_dict(to_port("nafnet", v), strict=True)
    tx = build_optimizer(sidd_optimizer_cfg())
    step = make_train_step(model, tx, remat=remat, precision=precision, ema_decay=0.999,
                           fused=fused)
    state = TrainState(step=0, module=model.module, optimizer=tx.init(model.module.parameters()),
                       ema=copy.deepcopy(model.module).requires_grad_(False))
    mets, snaps = [], {}
    for i, b in enumerate(batches(3)):
        m = step(state, {k: torch.from_numpy(a) for k, a in b.items()})
        mets.append({k: float(a) for k, a in m.items()})
        if i in (0, 2):
            snaps[i + 1] = ({k: t.clone() for k, t in state.module.state_dict().items()},
                            {k: t.clone() for k, t in state.ema.state_dict().items()})
    assert state.step == 3
    return mets, snaps
