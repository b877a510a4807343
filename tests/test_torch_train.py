"""Port parity: NAFNet training against the JAX package, on the CPU.

``nafblock_fused``'s output and gradients against ``jax.grad`` of the JAX
package's ``nafblock_fused`` (Pallas forward in interpret mode, the VJP of
``nafblock_xla`` backward); ``NAFBlockFused`` against autograd through
``nafblock_eager``; ``psnr_loss``, ``psnr``, ``psnr_per_image`` and
``ssim``; Adam and AdamW with the cosine schedule against optax; and one
and three float32 train steps against the JAX package's
``make_train_step`` with ``configs/nafnet_sidd.py``'s optimizer, remat off
and on, EMA 0.999 (the bf16-mixed steps are in ``test_torch_data.py``, so
that the two files' JAX compiles run on two workers). One set of weights,
drawn with numpy, goes through the weight bridge into both packages;
gradients and updated params of the JAX side are mapped into the port's
layout by the same bridge (its layout maps are transposes and reshapes,
linear).

Tolerances (each stated where it is used):
- the block, its gradients, the losses and metrics: 1e-5 x max(1, max|ref|);
- the optimizers: 1e-6 x max(1, max|ref|) over five steps;
- a float32 train step: loss, psnr 1e-4 x max(1, |ref|); params and EMA
  1e-5 absolute (an Adam step moves a param by about lr = 1e-3, so this is
  1% of a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enhax.kernels import nafblock as jnaf
from enhax.models.multitask.nafnet import NAFBlock as JaxNAFBlock
from enhax.nn import losses as jlosses
from enhax.nn import metrics as jmetrics
from enhax.nn.optim import build_optimizer as jax_build_optimizer
from enhax_torch.kernels import _launch, nafblock
from enhax_torch.models.multitask.nafnet import NAFBlock
from enhax_torch.nn import losses, metrics
from enhax_torch.nn.optim import build_optimizer
from torch_train_parity import draw_like, jax_run, port_run, to_port
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_OPT = 1e-6
TOL_STEP_LOSS = 1e-4
TOL_STEP_PARAM = 1e-5


def assert_close(out, ref, tol=TOL, what=""):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = ref.detach().float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (what, err, tol * scale)
    return err


# -- nafblock_fused ------------------------------------------------------------------

def block_case(c: int, tlc, seed: int = 0):
    """x, a cotangent, the JAX block's params and the port's block."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 12, 20, c)).astype(np.float32)
    ct = rng.normal(0, 1, x.shape).astype(np.float32)
    struct = jax.eval_shape(JaxNAFBlock(c, tlc_window=tlc).init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    p = draw_like(struct, rng)
    blk = NAFBlock(c, tlc_window=tlc)
    sd = to_port("nafnet_local", p, prefix="params/enc0_0/")
    blk.load_state_dict({k.removeprefix("encoders.0.0."): v for k, v in sd.items()})
    return x, ct, p, blk


@pytest.mark.parametrize("tlc", [None, 32])
@pytest.mark.parametrize("c", [8, 16])
def test_nafblock_fused_grads_match_jax(c, tlc):
    """Output and the gradients of sum(out * ct) for x and every param:
    the port's ``nafblock_fused`` (plain versions forward, autograd through
    ``nafblock_eager`` backward) against ``jax.grad`` of JAX's
    ``nafblock_fused(..., interpret=True)``. Tolerance 1e-5 x max(1, max|ref|)."""
    x, ct, p, blk = block_case(c, tlc)

    def f(xx, pp):
        out = jnaf.nafblock_fused(xx, pp, tlc, True)
        return jnp.sum(out * ct), out

    (_, ref_out), (gx, gp) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), p)
    xt = torch.from_numpy(x).requires_grad_()
    prm = dict(blk.named_parameters())
    out = nafblock.nafblock_fused(xt, prm, tlc)
    (out * torch.from_numpy(ct)).sum().backward()
    assert_close(out, ref_out, what="out")
    assert_close(xt.grad, gx, what="dx")
    ref_gp = {k.removeprefix("encoders.0.0."): v
              for k, v in to_port("nafnet_local", gp, prefix="params/enc0_0/").items()}
    assert set(ref_gp) == set(nafblock.PARAM_KEYS)
    for k in nafblock.PARAM_KEYS:
        assert_close(prm[k].grad, ref_gp[k], what=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nafblock_fused_grads_equal_eager_autograd(dtype):
    """On the CPU the fused block's backward is autograd through
    ``nafblock_eager`` recomputed: the same gradients, bit for bit, in x's
    and the params' dtype; the forward is ``nafblock_fast``'s."""
    x, ct, _, blk = block_case(16, 32, seed=3)
    blk.to(dtype)
    grads = []
    for fn in (nafblock.nafblock_fused, nafblock.nafblock_eager):
        blk.zero_grad()
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        out = fn(xt, dict(blk.named_parameters()), 32)
        (out.float() * torch.from_numpy(ct)).sum().backward()
        grads.append([xt.grad] + [p.grad for _, p in blk.named_parameters()])
        if fn is nafblock.nafblock_fused:
            with torch.no_grad():
                assert torch.equal(out, nafblock.nafblock_fast(xt, dict(blk.named_parameters()),
                                                               32))
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(a, b)


def test_nafblock_fused_skips_grads_not_asked_for():
    """Only the inputs that need a gradient get one (a frozen block, an
    input without grad)."""
    x, ct, _, blk = block_case(8, None)
    blk.requires_grad_(False)
    blk.conv3.weight.requires_grad_(True)
    out = nafblock.nafblock_fused(torch.from_numpy(x), dict(blk.named_parameters()))
    out.sum().backward()
    assert blk.conv3.weight.grad is not None
    assert all(p.grad is None for n, p in blk.named_parameters() if n != "conv3.weight")


def test_kernel_launches_refuse_autograd():
    """A kernel launch outside NAFBlockFused would be cut from the graph:
    the wrappers' check raises where autograd would record it, and not under
    no_grad (NAFBlockFused's forward)."""
    x = torch.zeros(1, 4, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _launch.refuse_grad("k1_apply", x)
    with torch.no_grad():
        _launch.refuse_grad("k1_apply", x)


def test_prepared_weights_miss_after_an_optimizer_step():
    """The bf16 forms' prepared weights: prepared once while the params stay
    as they are, anew after ``torch.optim``'s in-place (foreach) update, and
    never handed to a new tensor that took a freed one's id."""
    _, _, _, blk = block_case(8, None)
    blk.to(torch.bfloat16)
    p = dict(blk.named_parameters())
    first = nafblock.k1_weights(p)
    first_vec = first[1].clone()
    makes = _launch.prepared.makes
    assert nafblock.k1_weights(p) is first and _launch.prepared.makes == makes
    opt = torch.optim.AdamW(blk.parameters(), lr=1e-2, foreach=True)
    for q in blk.parameters():
        q.grad = torch.ones_like(q)
    opt.step()
    second = nafblock.k1_weights(p)
    assert second is not first and _launch.prepared.makes == makes + 1
    assert not torch.equal(second[1], first_vec)
    # bf16-mixed makes new copies every step, and a copy may take the id of
    # one freed before it: each is prepared anew, from its own values
    makes = _launch.prepared.makes
    for i in range(20):
        copies = {k: (v.detach().float() + i).to(torch.bfloat16) for k, v in p.items()}
        w1, _ = nafblock.k1_weights(copies)
        assert torch.equal(w1, copies["conv1.weight"].reshape(w1.shape))
        del copies, w1
    assert _launch.prepared.makes == makes + 20


# -- losses and metrics ----------------------------------------------------------------

@pytest.mark.parametrize("to_y", [False, True])
def test_losses_and_metrics_match_jax(to_y):
    """psnr_loss, psnr, psnr_per_image and ssim on random pairs;
    tolerance 1e-5 x max(1, max|ref|)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (3, 24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    assert_close(losses.psnr_loss(to_y=to_y)(ta, tb), jlosses.psnr_loss(to_y=to_y)(ja, jb))
    assert_close(metrics.psnr(ta, tb), jmetrics.psnr(ja, jb))
    assert_close(metrics.psnr_per_image(ta, tb), jmetrics.psnr_per_image(ja, jb))
    assert_close(metrics.ssim(ta, tb), jmetrics.ssim(ja, jb))
    assert_close(metrics.ssim(ta, tb, non_negative=True), jmetrics.ssim(ja, jb, non_negative=True))


# -- optimizers --------------------------------------------------------------------------

def opt_config(name: str, wd, clip=None) -> dict:
    opt = {"name": name, "lr": 1e-2, "betas": (0.9, 0.95)}
    if wd is not None:
        opt["weight_decay"] = wd
    return {"optimizer": opt, "grad_clip_norm": clip,
            "lr_scheduler": {"scheduler": {"name": "cosine_annealing_lr", "t_max": 4,
                                           "eta_min": 1e-4}}}


@pytest.mark.parametrize("name, wd, clip", [
    ("adamw", 0.0, None), ("adamw", 1e-2, None), ("adamw", None, None),
    ("adam", 0.0, None), ("adam", 1e-2, None), ("adamw", 1e-2, 0.5)])
def test_optimizer_matches_optax(name, wd, clip):
    """Five steps of random gradients with the cosine schedule (lr moving
    every step; t_max 4 takes it down and up again): the port's
    ``build_optimizer`` against the JAX package's on the same config.
    ``weight_decay`` None is each package's default (adamw: 1e-4).
    Tolerance 1e-6 x max(1, max|ref|)."""
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    cfg = opt_config(name, wd, clip)
    tx = jax_build_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tx_port = build_optimizer(cfg)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tx_port.init(tp.values())
    for count, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        tx_port.step(opt, count)
        for k in params:
            assert_close(tp[k], jp[k], TOL_OPT, what=(count, k))


def test_schedule_counts_steps_before_the_update():
    """lr of step n is schedule(n): the first update takes the base lr, and
    t_max counts steps."""
    tx = build_optimizer(opt_config("adamw", 0.0))
    assert tx.schedule(0) == pytest.approx(1e-2)
    assert tx.schedule(4) == pytest.approx(1e-4)
    opt = tx.init([torch.zeros(2, requires_grad=True)])
    opt.param_groups[0]["params"][0].grad = torch.ones(2)
    assert tx.step(opt, 2) == pytest.approx(1e-4 + 0.5 * (1e-2 - 1e-4))


@pytest.mark.parametrize("cfg, match", [
    ({"optimizer": {"name": "sgd", "lr": 1e-3}}, "sgd"),
    ({"optimizer": {"name": "lamb", "lr": 1e-3}}, "lamb"),
    ({"optimizer": "rmsprop", "lr_scheduler": {"scheduler": {"name": "constant_lr"}}},
     "rmsprop"),
    ({"optimizer": "lion", "freeze": {"match": "x", "after_steps": 1}}, "lion"),
])
def test_unported_optimizers_raise(cfg, match):
    """The JAX package's optimizers other than adam and adamw (no shipped
    config names one) raise, whatever the schedule or freeze beside them."""
    with pytest.raises(NotImplementedError, match=f"{match}.*1.12"):
        build_optimizer(cfg)


# -- the train step ----------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax_float32(remat):
    """One and three float32 steps of configs/nafnet_sidd.py's AdamW with the
    cosine schedule, EMA 0.999: loss and psnr of each step within 1e-4 x
    max(1, |ref|), params and EMA after steps 1 and 3 within 1e-5."""
    ref_m, ref_s = jax_run(remat, None)
    mets, snaps = port_run(remat, None, fused=False)
    for m, r in zip(mets, ref_m):
        for k in ("loss", "psnr"):
            assert abs(m[k] - r[k]) <= TOL_STEP_LOSS * max(1.0, abs(r[k])), (k, m[k], r[k])
    for n in (1, 3):
        for (params, ema), (ref_p, ref_e) in ((snaps[n], ref_s[n]),):
            for k, t in ref_p.items():
                assert float((params[k] - t).abs().max()) <= TOL_STEP_PARAM, (n, k)
                assert float((ema[k] - ref_e[k]).abs().max()) <= TOL_STEP_PARAM, (n, "ema", k)


@pytest.mark.parametrize("remat", [False, True])
def test_fused_train_step_equals_unfused_on_the_cpu(remat):
    """``fused=True`` on the CPU trains through ``nafblock_fused`` (the
    kernels' plain versions forward, eager autograd backward): float32
    loss, psnr, params and EMA as the module's forward gives them, within
    1e-5 (the fused block sums in another order)."""
    fused_m, fused_s = port_run(remat, None, fused=True)
    ref_m, ref_s = port_run(remat, None, fused=False)
    for m, r in zip(fused_m, ref_m):
        for k in ("loss", "psnr"):
            assert abs(m[k] - r[k]) <= TOL * max(1.0, abs(r[k])), (k, m[k], r[k])
    for n in (1, 3):
        for got, ref in zip(fused_s[n], ref_s[n]):
            for k, t in ref.items():
                assert float((got[k] - t).abs().max()) <= TOL, (n, k)


# -- schedules, the plateau scheduler, freeze, gradient accumulation -------------------

# every registered schedule of enhax/nn/optim.py, nested ones included; each
# run over steps 0..39 (past every period, warmup and milestone here)
SCHEDULES = [
    {"name": "cosine_annealing_restart_cyclic_lr", "periods": [5, 12],
     "restart_weights": [1, 0.5], "eta_mins": [3e-4, 1e-6]},
    {"name": "gradual_warmup_scheduler", "multiplier": 1, "total_epoch": 3,
     "after_scheduler": {"name": "cosine_annealing_restart_lr", "periods": [17],
                         "restart_weights": [1], "eta_min": 1e-7}},
    {"name": "gradual_warmup", "multiplier": 2, "total_epoch": 4,
     "scheduler": {"name": "step_lr", "step_size": 3}},
    {"name": "gradual_warmup", "multiplier": 1.5, "total_epoch": 5},
    {"name": "multistep_lr_restart", "milestones": [3, 8, 12], "restarts": [5, 10],
     "restart_weights": [0.5, 0.25]},
    {"name": "vibrate_lr", "total_iter": 400},
    {"name": "cosine_annealing_lr", "T_max": 10, "eta_min": 1e-5},
    {"name": "cosine_annealing_restart_lr", "periods": [4, 9], "restart_weights": [1, 0.3],
     "eta_min": 1e-6},
    {"name": "step_lr", "step_size": 4, "gamma": 0.5},
    {"name": "multistep_lr", "milestones": [2, 7]},
    {"name": "exponential_lr", "gamma": 0.9},
    {"name": "constant_lr"},
    {"name": "linear_lr", "start_factor": 0.3, "end_factor": 1.0, "total_iters": 9},
    {"name": "cosine_annealing_warm_restarts", "t_0": 3, "t_mult": 2, "eta_min": 1e-5},
    {"name": "cosine_annealing_warm_restarts", "t_0": 4},
    {"name": "cyclic_lr", "max_lr": 0.1, "step_size_up": 3, "step_size_down": 5,
     "mode": "triangular2"},
    {"name": "cyclic_lr", "max_lr": 0.1, "step_size_up": 4, "mode": "exp_range",
     "gamma": 0.95},
    {"name": "one_cycle_lr", "total_steps": 25},
    {"name": "one_cycle_lr", "total_steps": 25, "anneal_strategy": "linear",
     "pct_start": 0.04},
    {"name": "polynomial_lr", "total_iters": 12, "power": 2.0},
    {"name": "lambda_lr", "lr_lambda": lambda s: 0.9 ** s},
    {"name": "multiplicative_lr", "lr_lambda": lambda k: 0.95, "total_iters": 20},
    {"name": "sequential_lr", "milestones": [5],
     "schedulers": [{"name": "linear_lr", "start_factor": 0.1, "end_factor": 1.0,
                     "total_iters": 4}, {"name": "exponential_lr", "gamma": 0.9}]},
    {"name": "chained_scheduler",
     "schedulers": [{"name": "constant_lr"}, {"name": "exponential_lr", "gamma": 0.9}]},
    {"name": "cosine_annealing_restart_lr2", "periods": [5, 7, 9], "restarts": [4, 11],
     "restart_weights": [0.5, 0.25]},
]


@pytest.mark.parametrize("spec", SCHEDULES, ids=lambda s: s["name"])
def test_schedule_matches_jax(spec):
    """lr of steps 0..39 against the JAX package's ``build_schedule`` on the
    same spec, within 1e-6 x max(|ref|, base_lr): JAX evaluates in float32,
    whose cosine near a cycle's floor is off by ~1e-8 of base_lr (relative
    to an lr near eta_min that is more than 1e-6)."""
    from enhax.nn.optim import build_schedule as jax_build_schedule
    from enhax_torch.nn.optim import build_schedule
    base = 1e-2
    js, ts = jax_build_schedule(base, dict(spec)), build_schedule(base, dict(spec))
    for step in range(40):
        ref = float(js(step) if callable(js) else js)
        assert abs(ts(step) - ref) <= 1e-6 * max(abs(ref), base), (step, ts(step), ref)


def test_every_jax_schedule_is_registered():
    from enhax.constants import LR_SCHEDULERS as JAX_SCHEDULERS
    from enhax_torch.constants import LR_SCHEDULERS
    assert sorted(LR_SCHEDULERS) == sorted(JAX_SCHEDULERS)
    assert {LR_SCHEDULERS.canonical_name(s["name"]) for s in SCHEDULES} | {
        "reduce_lr_on_plateau"} == set(LR_SCHEDULERS)


@pytest.mark.parametrize("kw", [
    {"mode": "min", "patience": 1},
    {"mode": "max", "patience": 0, "factor": 0.5, "cooldown": 2, "min_lr": 3e-3},
    {"mode": "min", "patience": 2, "threshold": 0.1, "threshold_mode": "abs"},
])
def test_plateau_matches_jax(kw):
    """The plateau scheduler over one metric sequence: the lr after each
    ``step`` equal to the JAX package's (both are Python floats)."""
    from enhax.nn.optim import ReduceLROnPlateau as JaxPlateau
    from enhax_torch.nn.optim import ReduceLROnPlateau
    metrics = [1.0, 0.9, 0.95, 0.95, 0.94, 0.96, 0.5, 0.6, 0.6, 0.7, 0.2, 0.2, 0.2, 0.25]
    port, ref = ReduceLROnPlateau(1e-2, **kw), JaxPlateau(1e-2, **kw)
    got = [port.step(m) for m in metrics]
    assert got == [ref.step(m) for m in metrics]
    assert len(set(got)) > 1   # the sequence does move the lr


def test_plateau_config_keeps_the_lr_in_the_optimizer():
    """With ``reduce_lr_on_plateau`` the optimizer has no schedule: its steps
    leave the lr that ``set_opt_learning_rate`` wrote, as JAX's injected
    hyperparameter."""
    from enhax_torch.nn.optim import build_optimizer_with_plateau, set_opt_learning_rate
    cfg = {"optimizer": {"name": "adam", "lr": 1e-2},
           "lr_scheduler": {"scheduler": {"name": "reduce_lr_on_plateau", "patience": 0,
                                          "monitor": "val/psnr", "mode": "max"}}}
    tx, plateau, monitor = build_optimizer_with_plateau(cfg)
    assert tx.schedule is None and monitor == "val/psnr" and plateau.lr == 1e-2
    p = torch.zeros(2, requires_grad=True)
    opt = tx.init([p])
    p.grad = torch.ones(2)
    assert tx.step(opt, 0) == 1e-2
    set_opt_learning_rate(opt, plateau.step(1.0) * 0 + 5e-3)
    assert tx.step(opt, 1) == 5e-3 and opt.param_groups[0]["lr"] == 5e-3


def tiny_nafnet_pair():
    """The tiny NAFNet of the step tests in both packages, the port's loaded
    through the bridge."""
    from enhax_torch.models.base import build_model
    from torch_train_parity import TINY, tiny_weights
    jm, v = tiny_weights()
    model = build_model("nafnet", device="cpu", **TINY)
    model.module.load_state_dict(to_port("nafnet", v), strict=True)
    return jm, v, model


@pytest.mark.parametrize("case", ["freeze", "accumulate"])
def test_freeze_and_accumulation_match_jax_trainer(case):
    """Four mini-batches through both packages' ``Trainer`` steps, EMA
    0.999: ``freeze`` (``intro``, the first conv, frozen after 2 updates,
    AdamW with decay 1e-2 so that the decoupled decay would move it) or
    ``accumulate_grad_batches=2`` with the gradient norm clipped to 0.05
    (the clip binds on the mean). Params and EMA after each mini-batch
    within 1e-5 x max(1, max|ref|) (1% of an update at lr 1e-3, as the step
    tests), the lr the port's optimizer holds equal
    to the schedule at JAX's update count, and the frozen conv unmoved from
    update 2 on."""
    from enhax.train.trainer import Trainer as JaxTrainer
    from enhax_torch.train import Trainer
    from torch_train_parity import batches
    jm, v, model = tiny_nafnet_pair()
    cfg = {"optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-2},
           "lr_scheduler": {"scheduler": {"name": "cosine_annealing_lr", "t_max": 3,
                                          "eta_min": 1e-5}}}
    kw = {"ema_decay": 0.999}
    if case == "freeze":
        cfg["freeze"] = {"match": "intro", "after_steps": 2}
    else:
        kw.update(accumulate_grad_batches=2, gradient_clip_val=0.05)
    jt = JaxTrainer(jm, cfg, **kw)
    data = batches(4, seed=21)
    # a copy: the JAX step donates its state, and ``v`` is the cached draw
    jstate = jt.init_state(jt._place(data[0]), params=jax.tree_util.tree_map(jnp.copy, v))
    tr = Trainer(model, cfg, **kw)
    state = tr.init_state()
    rng = jax.random.PRNGKey(0)
    intro = {}
    for i, b in enumerate(data):
        jstate, _ = jt._train_step(jstate, jt._place(b), rng)
        tr._train_step(state, {k: torch.from_numpy(a) for k, a in b.items()})
        ref_p, ref_e = to_port("nafnet", jstate.params), to_port("nafnet", jstate.ema)
        for k, t in ref_p.items():
            assert_close(state.module.state_dict()[k], t, TOL_STEP_PARAM, what=(i, k))
            assert_close(state.ema.state_dict()[k], ref_e[k], TOL_STEP_PARAM, what=(i, "ema", k))
        updates = jstate.opt_state.gradient_step if case == "accumulate" else i + 1
        assert int(updates) == (i + 1) // (2 if case == "accumulate" else 1)
        if int(updates):
            assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
                tr.tx.schedule(int(updates) - 1), rel=1e-12)
        intro[i] = state.module.intro.weight.detach().clone()
    assert state.step == 4
    if case == "freeze":
        assert torch.equal(intro[1], intro[3]) and not torch.equal(intro[0], intro[1])


@pytest.mark.parametrize("name, kw", [
    ("l1_loss", {}), ("l1_loss", {"loss_weight": 0.5, "reduction": "sum"}),
    ("l2_loss", {"reduction": "none"}), ("charbonnier_loss", {"eps": 1e-2}),
    ("smooth_l1_loss", {"beta": 0.05}), ("ssim_loss", {}),
    ("ms_ssim_loss", {"loss_weight": 2.0}),
])
def test_pixel_losses_match_jax(name, kw):
    """The pixel and SSIM losses of ``LOSSES`` against the JAX package's on
    random pairs (ms_ssim_loss at 3 scales of 64x64), within 1e-5 x max(1,
    max|ref|)."""
    from enhax.constants import LOSSES as JAX_LOSSES
    from enhax_torch.constants import LOSSES
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    out = LOSSES.build(name, **kw)(torch.from_numpy(a), torch.from_numpy(b))
    assert_close(out, JAX_LOSSES.build(name, **kw)(jnp.asarray(a), jnp.asarray(b)))
