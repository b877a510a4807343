"""Optimizers and learning-rate schedules of the port.

Port of ``enhax/nn/optim.py``: ``build_optimizer`` for ``adam`` and
``adamw`` (with ``grad_clip_norm`` and ``freeze``), every registered
schedule (nested ones through ``after_scheduler`` / ``scheduler``), and the
plateau scheduler (``build_optimizer_with_plateau``,
``set_opt_learning_rate``). The JAX package's other optimizers raise
``NotImplementedError`` (ROADMAP item 1.12): no shipped config names one.

A schedule is a function of the optimizer's update count, counted before
the update as optax's ``scale_by_schedule`` counts: the first update uses
``schedule(0)``, and ``t_max`` counts updates, not epochs. ``Optimizer.step``
writes it into every param group before ``torch.optim``'s step, so no
``torch.optim.lr_scheduler`` (whose ``last_epoch`` is one off from that
count) is used. With the plateau scheduler the lr lives in the param groups
(``Optimizer.schedule`` is None) and only ``set_opt_learning_rate`` writes
it, as JAX's ``optax.inject_hyperparams`` keeps it in the optimizer state.

How the two packages agree: optax's ``adam`` with a weight decay chains
``add_decayed_weights`` before it, which is ``torch.optim.Adam``'s
``weight_decay`` (the decay added to the gradient); optax's ``adamw``
multiplies its decay by the scheduled lr, as ``torch.optim.AdamW``'s
``p *= 1 - lr * wd`` does, and defaults it to 1e-4 where torch's default
is 1e-2. Both take bias-corrected moments and add ``eps`` outside the
square root.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Sequence

import numpy as np
import torch

from enhax_torch.constants import LR_SCHEDULERS, OPTIMIZERS

_ITEM = "ROADMAP item 1.12"


@OPTIMIZERS.register(name="adam")
def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> tuple:
    return torch.optim.Adam, {"betas": (b1, b2), "eps": eps, "weight_decay": weight_decay}


@OPTIMIZERS.register(name="adamw")
def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> tuple:
    return torch.optim.AdamW, {"betas": (b1, b2), "eps": eps, "weight_decay": weight_decay}


# -- schedules: each registered entry takes base_lr and returns step -> lr ----

def _cosine(eta_min: float, peak: float, t: float, period: float) -> float:
    return eta_min + 0.5 * (peak - eta_min) * (1 + math.cos(math.pi * t / period))


@LR_SCHEDULERS.register(name="cosine_annealing_restart_lr")
def cosine_annealing_restart_lr(base_lr: float, periods, restart_weights=(1,),
                                eta_min: float = 0.0) -> Callable:
    """BasicSR's cosine annealing with restarts: period i starts at the sum
    of the periods before it, its cosine scaled by ``restart_weights[i]``.
    Step s is in the first period whose end is >= s, the last one past the
    end (``idx = sum(s > ends)``, clipped)."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights must have equal length")
    ends = [sum(periods[: i + 1]) for i in range(len(periods))]
    starts = [0] + ends[:-1]

    def schedule(step: int) -> float:
        idx = min(sum(step > e for e in ends), len(periods) - 1)
        return eta_min + restart_weights[idx] * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * (step - starts[idx]) / periods[idx]))
    return schedule


@LR_SCHEDULERS.register(name="cosine_annealing_restart_cyclic_lr")
def cosine_annealing_restart_cyclic_lr(base_lr: float, periods, restart_weights=(1,),
                                       eta_mins=(0.0,)) -> Callable:
    """As ``cosine_annealing_restart_lr`` with an ``eta_min`` per period
    (the last one repeated where ``eta_mins`` is shorter)."""
    ends = [sum(periods[: i + 1]) for i in range(len(periods))]
    starts = [0] + ends[:-1]

    def schedule(step: int) -> float:
        idx = min(sum(step > e for e in ends), len(periods) - 1)
        em = eta_mins[min(idx, len(eta_mins) - 1)]
        return em + restart_weights[idx] * 0.5 * (base_lr - em) * (
            1 + math.cos(math.pi * (step - starts[idx]) / periods[idx]))
    return schedule


@LR_SCHEDULERS.register(name="gradual_warmup", aliases=["gradual_warmup_scheduler"])
def gradual_warmup(base_lr: float, multiplier: float = 1.0, total_epoch: int = 10,
                   after_scheduler=None) -> Callable:
    """Linear warmup to multiplier * base_lr over ``total_epoch`` steps, then
    ``after_scheduler`` counted from the warmup's end (or the warm lr)."""
    def schedule(step: int) -> float:
        if step < total_epoch:
            return base_lr * ((multiplier - 1.0) * step / total_epoch + 1.0)
        if after_scheduler is not None:
            return after_scheduler(max(step - total_epoch, 0))
        return base_lr * multiplier
    return schedule


@LR_SCHEDULERS.register(name="multistep_lr_restart")
def multistep_lr_restart(base_lr: float, milestones, gamma: float = 0.1, restarts=(0,),
                         restart_weights=(1,)) -> Callable:
    """MultiStepLR with restarts: the last restart at or before the step
    (restart epochs shifted by +1, as the reference does) resets the lr to
    base_lr * its weight, and each milestone after it decays by gamma."""
    ms = sorted(milestones)
    rs = [r + 1 for r in restarts]

    def schedule(step: int) -> float:
        started = [i for i, r in enumerate(rs) if step >= r]
        if started:
            last = max(started, key=lambda i: rs[i])
            last_r, weight = rs[last], restart_weights[last]
        else:
            last_r, weight = 0, 1.0
        decays = sum(1 for m in ms if last_r < m <= step)
        return base_lr * weight * gamma ** decays
    return schedule


@LR_SCHEDULERS.register(name="vibrate_lr")
def vibrate_lr(base_lr: float, total_iter: int) -> Callable:
    """The reference's decaying triangle wave."""
    t_period = max(total_iter // 80, 2)
    th = max(t_period // 2, 1)

    def schedule(step: int) -> float:
        process = step / total_iter
        f = 1 - process * 8 / 3 if process < 3 / 8 else (0.2 if process < 5 / 8 else 0.1)
        t = step % t_period
        weight = f * (2 - t / th if t >= th else t / th)
        if step < th:
            weight = max(weight, 0.1)
        return base_lr * weight
    return schedule


@LR_SCHEDULERS.register(name="cosine_annealing_lr")
def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable:
    return lambda step: _cosine(eta_min, base_lr, step, t_max)


@LR_SCHEDULERS.register(name="step_lr")
def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable:
    return lambda step: base_lr * gamma ** (step // step_size)


@LR_SCHEDULERS.register(name="multistep_lr")
def multistep_lr(base_lr: float, milestones, gamma: float = 0.1) -> Callable:
    ms = sorted(milestones)
    return lambda step: base_lr * gamma ** sum(step >= m for m in ms)


@LR_SCHEDULERS.register(name="exponential_lr")
def exponential_lr(base_lr: float, gamma: float = 0.99) -> Callable:
    return lambda step: base_lr * gamma ** step


@LR_SCHEDULERS.register(name="constant_lr")
def constant_lr(base_lr: float) -> Callable:
    return lambda step: base_lr


@LR_SCHEDULERS.register(name="linear_lr")
def linear_lr(base_lr: float, start_factor: float = 1.0, end_factor: float = 0.0,
              total_iters: int = 1000) -> Callable:
    def schedule(step: int) -> float:
        frac = min(max(step / total_iters, 0.0), 1.0)
        return base_lr * (start_factor + (end_factor - start_factor) * frac)
    return schedule


@LR_SCHEDULERS.register(name="cosine_annealing_warm_restarts")
def cosine_annealing_warm_restarts(base_lr: float, t_0: int, t_mult: int = 1,
                                   eta_min: float = 0.0) -> Callable:
    """SGDR: a cosine within each cycle, the cycles t_0 * t_mult**n long."""
    if t_mult < 1:
        raise ValueError("t_mult must be >= 1")

    def schedule(step: int) -> float:
        if t_mult == 1:
            return _cosine(eta_min, base_lr, step % t_0, t_0)
        n = math.floor(math.log(step / t_0 * (t_mult - 1) + 1) / math.log(t_mult))
        t_cur = step - t_0 * (t_mult ** n - 1) / (t_mult - 1)
        return _cosine(eta_min, base_lr, t_cur, t_0 * t_mult ** n)
    return schedule


@LR_SCHEDULERS.register(name="cyclic_lr")
def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int = 2000,
              step_size_down: int | None = None, mode: str = "triangular",
              gamma: float = 1.0) -> Callable:
    """torch's CyclicLR: a triangle between base_lr and max_lr; triangular2
    halves the amplitude each cycle, exp_range scales it by gamma**step."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown cyclic mode {mode!r}")
    down = step_size_up if step_size_down is None else step_size_down
    total = step_size_up + down
    up_frac = step_size_up / total

    def schedule(step: int) -> float:
        cycle = math.floor(1.0 + step / total)
        x = 1.0 + step / total - cycle
        scale_x = x / up_frac if x <= up_frac else (1.0 - x) / (1.0 - up_frac)
        amp = {"triangular": 1.0, "triangular2": 1.0 / 2.0 ** (cycle - 1),
               "exp_range": gamma ** step}[mode]
        return base_lr + (max_lr - base_lr) * scale_x * amp
    return schedule


@LR_SCHEDULERS.register(name="one_cycle_lr")
def one_cycle_lr(base_lr: float, total_steps: int, pct_start: float = 0.3,
                 anneal_strategy: str = "cos", div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> Callable:
    """torch's OneCycleLR with ``base_lr`` as its ``max_lr``: up from
    base_lr / div_factor over pct_start of the run, then down to that over
    final_div_factor."""
    if anneal_strategy not in ("cos", "linear"):
        raise ValueError(f"unknown anneal_strategy {anneal_strategy!r}")
    initial = base_lr / div_factor
    final = initial / final_div_factor
    # as the JAX package: a warmup of one step would be 0/0 at step 0
    up_steps = max(float(pct_start * total_steps) - 1.0, 1e-6)
    down_steps = max(float(total_steps - 1) - up_steps, 1e-6)

    def anneal(start, end, frac):
        if anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * frac))
        return start + (end - start) * frac

    def schedule(step: int) -> float:
        if step <= up_steps:
            return anneal(initial, base_lr, min(max(step / up_steps, 0.0), 1.0))
        return anneal(base_lr, final, min(max((step - up_steps) / down_steps, 0.0), 1.0))
    return schedule


@LR_SCHEDULERS.register(name="polynomial_lr")
def polynomial_lr(base_lr: float, total_iters: int = 5, power: float = 1.0) -> Callable:
    return lambda step: base_lr * (1.0 - min(max(step / total_iters, 0.0), 1.0)) ** power


@LR_SCHEDULERS.register(name="lambda_lr")
def lambda_lr(base_lr: float, lr_lambda) -> Callable:
    return lambda step: base_lr * lr_lambda(step)


@LR_SCHEDULERS.register(name="multiplicative_lr")
def multiplicative_lr(base_lr: float, lr_lambda, total_iters: int = 10000) -> Callable:
    """lr(n) = base_lr * prod_{k=1..n} lr_lambda(k), tabulated to
    ``total_iters`` (held at the end) as the JAX package does."""
    table = base_lr * np.cumprod([1.0] + [float(lr_lambda(k))
                                          for k in range(1, total_iters + 1)])
    return lambda step: float(table[min(max(int(step), 0), total_iters)])


@LR_SCHEDULERS.register(name="sequential_lr")
def sequential_lr(base_lr: float, schedulers: Sequence[dict], milestones) -> Callable:
    """torch's SequentialLR: the child whose span holds the step, counted
    from its start."""
    if len(schedulers) != len(milestones) + 1:
        raise ValueError("need len(schedulers) == len(milestones) + 1")
    children = [build_schedule(base_lr, dict(s)) for s in schedulers]
    starts = [0] + list(milestones)

    def schedule(step: int) -> float:
        idx = sum(step >= m for m in milestones)
        return children[idx](step - starts[idx])
    return schedule


@LR_SCHEDULERS.register(name="chained_scheduler")
def chained_scheduler(base_lr: float, schedulers: Sequence[dict]) -> Callable:
    """torch's ChainedScheduler: base_lr times every child's factor."""
    children = [build_schedule(base_lr, dict(s)) for s in schedulers]

    def schedule(step: int) -> float:
        lr = base_lr
        for c in children:
            lr *= c(step) / base_lr
        return lr
    return schedule


@LR_SCHEDULERS.register(name="reduce_lr_on_plateau")
class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau: the lr falls by ``factor`` once the metric
    has not improved for more than ``patience`` epochs. ``step(metric)``
    once a validation; ``lr`` (or a call with any step) reads it. The
    Trainer steps it on its monitor and writes the lr into the optimizer
    with ``set_opt_learning_rate``."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0, min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min|max")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be rel|abs")
        self.lr = float(base_lr)
        self.mode, self.factor = mode, factor
        self.patience, self.threshold = patience, threshold
        self.threshold_mode, self.cooldown = threshold_mode, cooldown
        self.min_lr = min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        rel = self.threshold_mode == "rel"
        if self.mode == "min":
            return current < (self.best * (1.0 - self.threshold) if rel
                              else self.best - self.threshold)
        return current > (self.best * (1.0 + self.threshold) if rel
                          else self.best + self.threshold)

    def step(self, metric) -> float:
        current = float(metric)
        if self._is_better(current):
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def __call__(self, step=None) -> float:
        return self.lr


@LR_SCHEDULERS.register(name="cosine_annealing_restart_lr2")
def cosine_annealing_restart_lr2(base_lr: float, periods, restarts, restart_weights=(1,),
                                 eta_min: float = 0.0) -> Callable:
    """The reference's CosineAnnealingRestartLR2 in closed form: at restart
    r_i (shifted by +1, as the reference does) the lr resets to
    restart_weights[i] * base_lr and runs a cosine of period periods[i+1]."""
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights must match in length")
    rs = [0] + [v + 1 for v in restarts]
    ws = [1.0] + list(restart_weights)
    ps = list(periods[: len(rs)])

    def schedule(step: int) -> float:
        idx = sum(step >= r for r in rs) - 1
        return _cosine(eta_min, ws[idx] * base_lr, step - rs[idx], ps[idx])
    return schedule


def build_schedule(base_lr: float, spec: dict | None) -> Callable[[int], float]:
    """A schedule from a ``{name, **kwargs, after_scheduler?}`` dict (a
    nested spec under ``after_scheduler`` or ``scheduler``); ``None`` is
    constant."""
    if not spec:
        return constant_lr(base_lr)
    spec = dict(spec)
    if "T_max" in spec:  # torch CosineAnnealingLR's spelling
        spec["t_max"] = spec.pop("T_max")
    name = spec.pop("name")
    after = spec.pop("after_scheduler", None) or spec.pop("scheduler", None)
    if after is not None:
        spec["after_scheduler"] = build_schedule(base_lr, after)
    return LR_SCHEDULERS.build(name, base_lr=base_lr, **spec)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``build_optimizer`` returns: a ``torch.optim`` class with its
    arguments, the schedule (None where the lr lives in the param groups,
    the plateau scheduler's case), the gradient-norm clip and the freeze.
    ``init(params)`` makes the ``torch.optim`` object (the optimizer state);
    ``step(opt, count)`` clips, sets the lr of update ``count``, steps, and
    puts back the frozen parameters."""

    cls: type
    kwargs: dict
    schedule: Callable[[int], float] | None
    grad_clip_norm: float | None = None
    base_lr: float = 1e-3
    freeze: tuple | None = None   # (compiled regex, after_steps)

    def init(self, params) -> torch.optim.Optimizer:
        """The ``torch.optim`` object over ``params``: tensors, or (name,
        tensor) pairs (``module.named_parameters()``), which a ``freeze``
        needs: its regex matches the names."""
        params = list(params)
        named = [p for p in params if isinstance(p, tuple)]
        tensors = [p[1] if isinstance(p, tuple) else p for p in params]
        if self.freeze is not None and len(named) != len(params):
            raise ValueError("freeze matches parameter names: pass module.named_parameters()")
        lr = self.base_lr if self.schedule is None else float(self.schedule(0))
        opt = self.cls(tensors, lr=lr, **self.kwargs)
        if self.freeze is not None:
            opt.frozen_params = [p for n, p in named if self.freeze[0].search(n)]
        return opt

    def step(self, opt: torch.optim.Optimizer, count: int) -> float:
        if self.schedule is not None:
            for group in opt.param_groups:
                group["lr"] = float(self.schedule(count))
        if self.grad_clip_norm:
            torch.nn.utils.clip_grad_norm_(
                [p for g in opt.param_groups for p in g["params"]], self.grad_clip_norm)
        frozen = [] if self.freeze is None or count < self.freeze[1] else opt.frozen_params
        keep = [p.detach().clone() for p in frozen]
        opt.step()
        if frozen:
            # JAX masks the final updates: AdamW's decoupled decay moves a
            # parameter whose gradient is zero, so put the values back
            with torch.no_grad():
                torch._foreach_copy_(frozen, keep)
        return opt.param_groups[0]["lr"]


def build_optimizer(config: dict) -> Optimizer:
    """An ``Optimizer`` from the JAX package's config dict:

    ``{"optimizer": {"name": "adamw", "lr": 1e-3, "betas": (0.9, 0.9),
    "weight_decay": 0.0} | "adam", "lr_scheduler": {"scheduler": {"name":
    "cosine_annealing_lr", "t_max": 200, "eta_min": 1e-7}} | None,
    "grad_clip_norm": float | None, "freeze": {"match": regex, "after_steps":
    n} | None}``, or the flat ``{"name": ..., "lr": ...}``. ``freeze``
    matches its regex against the port's parameter names (the reference
    torch names) and keeps the matches where they are from update
    ``after_steps`` on.
    """
    return build_optimizer_with_plateau(config)[0]


def build_optimizer_with_plateau(config: dict) -> tuple:
    """``(Optimizer, plateau, monitor)``: with a ``reduce_lr_on_plateau``
    spec the optimizer has no schedule, and the ``ReduceLROnPlateau`` and
    its monitor key (default ``val/loss``) are returned for the Trainer to
    step; otherwise ``(Optimizer, None, None)``."""
    cfg = dict(config)
    opt_cfg = cfg.get("optimizer", cfg)
    if isinstance(opt_cfg, str):
        opt_cfg = {"name": opt_cfg}
    opt_cfg = dict(opt_cfg)
    name = opt_cfg.pop("name")
    lr = opt_cfg.pop("lr", opt_cfg.pop("learning_rate", 1e-3))
    if "betas" in opt_cfg:
        opt_cfg["b1"], opt_cfg["b2"] = opt_cfg.pop("betas")
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported ({_ITEM})")
    spec = cfg.get("lr_scheduler")
    if isinstance(spec, dict) and "scheduler" in spec:
        spec = spec["scheduler"]
    plateau = monitor = None
    if isinstance(spec, dict) and spec.get("name") and _is_plateau(spec["name"]):
        plateau = ReduceLROnPlateau(lr, **{k: v for k, v in spec.items()
                                           if k not in ("name", "monitor")})
        monitor = spec.get("monitor", "val/loss")
        schedule = None
    else:
        schedule = build_schedule(lr, spec)
    kwargs = {k: v for k, v in opt_cfg.items()
              if k in ("b1", "b2", "eps", "weight_decay") and v is not None}
    cls, torch_kwargs = OPTIMIZERS.build(name, **kwargs)
    frz = cfg.get("freeze")
    freeze = (re.compile(frz["match"]), int(frz["after_steps"])) if frz else None
    tx = Optimizer(cls, torch_kwargs, schedule, cfg.get("grad_clip_norm"), float(lr), freeze)
    return tx, plateau, monitor


def _is_plateau(name: str) -> bool:
    try:
        return LR_SCHEDULERS.canonical_name(name) == "reduce_lr_on_plateau"
    except KeyError:
        return False


def set_opt_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group (the plateau scheduler's write,
    JAX's ``set_opt_learning_rate`` on the injected hyperparameter)."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
