"""The optimizer-state bridge: a JAX trainer checkpoint resumed in the port.

Three JAX train steps, ``save_checkpoint`` (orbax) and ``load_checkpoint``,
then ``jax_checkpoint_to_torch`` into the port's ``state.pt`` payload,
``load_checkpoint`` into a port ``TrainState`` and three more port steps on
the next batches; against six JAX steps on the same batches: the params,
the EMA shadow and the Adam moments (``exp_avg``/``exp_avg_sq`` against
optax's ``mu``/``nu``, the step count against its ``count``). Cases:

  * ``nafnet_tiny`` (``run/make_quality.py``'s width 8) with
    ``configs/nafnet_sidd.py``'s AdamW and cosine schedule, EMA 0.9;
  * ``zero_dce_re`` (16 channels) with Adam and the gradient norm clipped
    to 0.1, the quality chain's recipe;
  * ``nafnet_tiny`` with ``accumulate_grad_batches=2``, saved after three
    mini-batches: optax's ``MultiSteps`` holds the first of the second
    cycle's gradients (``acc_grads``), which the bridge carries into the
    port's ``.grad`` (the port's own checkpoint keeps it too).

Tolerance: 1e-5 x max(1, max|ref|) per tensor, float32 on the CPU.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax.train.checkpoints import load_checkpoint as jax_load_checkpoint
from enhax.train.checkpoints import save_checkpoint as jax_save_checkpoint
from enhax.train.trainer import TrainState as JaxTrainState
from enhax.train.trainer import make_train_step as jax_make_train_step
from enhax_torch.convert.from_jax import jax_checkpoint_to_torch, jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train import TrainState, make_train_step
from enhax_torch.train.checkpoints import STATE_FILE, load_checkpoint, save_checkpoint
from torch_train_parity import draw_like, flat_params, sidd_optimizer_cfg

TOL = 1e-5
NAF_TINY = {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1), "dec_blk_nums": (1, 1)}
CASES = {
    "nafnet_adamw_ema": ("nafnet", NAF_TINY, None, 0.9, 1, True),
    "zero_dce_adam_clip": ("zero_dce_re", {"num_channels": 16},
                           {"optimizer": {"name": "adam", "lr": 1e-3}, "grad_clip_norm": 0.1},
                           None, 1, False),
    "nafnet_accumulate_mid_cycle": ("nafnet", NAF_TINY, None, None, 2, True),
}


def close(out, ref, what):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    err = float(np.abs(out - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), (what, err)


def data(supervised: bool, n: int = 6):
    rng = np.random.default_rng(21)
    out = []
    for _ in range(n):
        ref = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
        img = np.clip(ref * 0.4 + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
        out.append({"image": img, "ref_image": ref} if supervised else {"image": img})
    return out


def adam_state(opt_state):
    """optax's ScaleByAdamState inside a chain / MultiSteps."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_resumes_in_the_port(case, tmp_path):
    name, cfg, opt_cfg, ema_decay, k, supervised = CASES[case]
    opt_cfg = opt_cfg or sidd_optimizer_cfg()
    batches = data(supervised)
    jm = jax_build_model(name, **cfg)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 32, 32, 3))})
    v = draw_like(struct, np.random.default_rng(3))
    tx = jax_build_optimizer(opt_cfg)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    step = jax_make_train_step(jm, tx, donate=False, ema_decay=ema_decay)
    ema = jax.tree_util.tree_map(jnp.copy, v) if ema_decay else None
    state = JaxTrainState(step=0, params=v, opt_state=tx.init(v), ema=ema)
    rng = jax.random.PRNGKey(0)
    for i, b in enumerate(batches):
        state, _ = step(state, {kk: jnp.asarray(a) for kk, a in b.items()}, rng)
        if i == 2:
            jax_save_checkpoint(tmp_path / "jax", state, epoch=0)
    restored, epoch = jax_load_checkpoint(tmp_path / "jax" / "last", JaxTrainState(
        step=0, params=v, opt_state=tx.init(v), ema=ema))
    assert epoch == 1 and int(restored.step) == 3
    payload = jax_checkpoint_to_torch(
        name, {"step": restored.step, "epoch": 0, "params": restored.params,
               "opt_state": restored.opt_state, "ema": restored.ema},
        opt_cfg, {"accumulate_grad_batches": k}, cfg)
    assert ("grads" in payload) == (k > 1)
    (tmp_path / "port" / "last").mkdir(parents=True)
    torch.save(payload, tmp_path / "port" / "last" / STATE_FILE)

    model = build_model(name, device="cpu", **cfg)
    ptx = build_optimizer(opt_cfg)
    pstate = TrainState(0, model.module, ptx.init(list(model.module.named_parameters())),
                        copy.deepcopy(model.module).requires_grad_(False) if ema_decay else None,
                        accumulate_grad_batches=k)
    pstate, start = load_checkpoint(tmp_path / "port" / "last", pstate)
    assert start == 1 and pstate.step == 3
    pstep = make_train_step(model, ptx, ema_decay=ema_decay, accumulate_grad_batches=k)
    for b in batches[3:]:
        pstep(pstate, {kk: torch.from_numpy(a) for kk, a in b.items()})
        if pstate.step == 5 and k > 1:
            # the port's own checkpoint inside a cycle keeps the partial sum
            save_checkpoint(tmp_path / "port2", pstate, epoch=1)

    ref = jax_to_torch_state_dict(name, flat_params(state.params))
    for key, t in pstate.module.state_dict().items():
        close(t, ref[key], key)
    if ema_decay:
        ref = jax_to_torch_state_dict(name, flat_params(state.ema))
        for key, t in pstate.ema.state_dict().items():
            close(t, ref[key], "ema " + key)
    adam = adam_state(state.opt_state)
    mu = jax_to_torch_state_dict(name, flat_params(adam.mu))
    nu = jax_to_torch_state_dict(name, flat_params(adam.nu))
    for key, p in pstate.module.named_parameters():
        st = pstate.optimizer.state[p]
        assert int(st["step"]) == int(adam.count) == 6 // k
        close(st["exp_avg"], mu[key], "exp_avg " + key)
        close(st["exp_avg_sq"], nu[key], "exp_avg_sq " + key)
    if k > 1:
        saved = torch.load(tmp_path / "port2" / "last" / STATE_FILE, weights_only=True)
        assert saved["step"] == 5 and set(saved["grads"]) == {
            n for n, _ in model.module.named_parameters()}


def test_bridge_refuses_what_it_cannot_carry():
    """An optimizer state without Adam's moments, and an accumulation
    checkpoint bridged without the run's k, raise."""
    jm = jax_build_model("zero_dce_re", num_channels=4)
    v = draw_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                 {"image": jnp.zeros((1, 16, 16, 3))}), np.random.default_rng(0))
    cfg = {"optimizer": {"name": "adam", "lr": 1e-3}}
    payload = {"step": 0, "epoch": 0, "params": v, "opt_state": optax.sgd(0.1).init(v)}
    with pytest.raises(ValueError, match="Adam"):
        jax_checkpoint_to_torch("zero_dce_re", payload, cfg, model_cfg={"num_channels": 4})
    payload["opt_state"] = optax.MultiSteps(jax_build_optimizer(cfg), 2).init(v)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        jax_checkpoint_to_torch("zero_dce_re", payload, cfg, model_cfg={"num_channels": 4})


def test_tool_converts_an_orbax_checkpoint(tmp_path):
    """``tools/jax_ckpt_to_torch.py`` on a JAX trainer's orbax directory: the
    port's trainer resumes from what it writes, at the JAX run's step and
    with its weights."""
    import sys
    from pathlib import Path

    from enhax.train import Trainer as JaxTrainer
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    try:
        from jax_ckpt_to_torch import main
    finally:
        sys.path.pop(0)
    opt = {"optimizer": {"name": "adam", "lr": 1e-3}, "grad_clip_norm": 0.1}
    jm = jax_build_model("zero_dce_re", num_channels=4)
    batch = data(False, 1)[0]
    JaxTrainer(jm, opt, max_epochs=2, seed=0, ckpt_dir=tmp_path / "jax",
               log_every_n_steps=10**6).fit(lambda: [batch], resume=False)
    main([str(tmp_path / "jax" / "last"), str(tmp_path / "port" / "last"), "--model",
          "zero_dce_re", "--model-cfg", '{"num_channels": 4}', "--optimizer-cfg",
          '{"optimizer": {"name": "adam", "lr": 0.001}, "grad_clip_norm": 0.1}'])
    model = build_model("zero_dce_re", device="cpu", num_channels=4)
    tx = build_optimizer(opt)
    state = TrainState(0, model.module, tx.init(list(model.module.named_parameters())))
    state, start = load_checkpoint(tmp_path / "port" / "last", state)
    assert state.step == 2 and start == 2
    assert all(int(s["step"]) == 2 for s in state.optimizer.state.values())
