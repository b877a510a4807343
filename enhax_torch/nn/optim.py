"""Optimizers and learning-rate schedules of the port.

Port of the part of ``enhax/nn/optim.py`` that the NAFNet, HINet and
Zero-DCE recipes need: ``build_optimizer`` for ``adam`` and ``adamw`` (with
``grad_clip_norm``) and ``build_schedule`` with ``cosine_annealing_lr``,
``cosine_annealing_restart_lr`` and ``constant_lr``.
The other optimizers and schedules, the plateau scheduler and ``freeze``
raise ``NotImplementedError`` (ROADMAP item 1.12).

A schedule is a function of the optimizer's step count, counted before the
step as optax's ``scale_by_schedule`` counts: the first update uses
``schedule(0)``, and ``t_max`` counts steps, not epochs. ``Optimizer.step``
writes it into every param group before ``torch.optim``'s step, so no
``torch.optim.lr_scheduler`` (whose ``last_epoch`` is one off from that
count) is used.

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
from typing import Callable

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


@LR_SCHEDULERS.register(name="cosine_annealing_lr")
def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable:
    def schedule(step: int) -> float:
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * step / t_max))
    return schedule


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


@LR_SCHEDULERS.register(name="constant_lr")
def constant_lr(base_lr: float) -> Callable:
    return lambda step: base_lr


def build_schedule(base_lr: float, spec: dict | None) -> Callable[[int], float]:
    """A schedule from a ``{name, **kwargs}`` dict; ``None`` is constant."""
    if not spec:
        return constant_lr(base_lr)
    spec = dict(spec)
    if "T_max" in spec:  # torch CosineAnnealingLR's spelling
        spec["t_max"] = spec.pop("T_max")
    name = spec.pop("name")
    if spec.pop("after_scheduler", None) or spec.pop("scheduler", None):
        raise NotImplementedError(f"nested schedules ({name}) are not ported ({_ITEM})")
    if name not in LR_SCHEDULERS:
        raise NotImplementedError(f"lr scheduler {name!r} is not ported ({_ITEM})")
    return LR_SCHEDULERS.build(name, base_lr=base_lr, **spec)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``build_optimizer`` returns: a ``torch.optim`` class with its
    arguments, the schedule and the gradient-norm clip. ``init(params)``
    makes the ``torch.optim`` object (the optimizer state); ``step(opt,
    count)`` clips, sets the lr for step ``count`` and steps."""

    cls: type
    kwargs: dict
    schedule: Callable[[int], float]
    grad_clip_norm: float | None = None

    def init(self, params) -> torch.optim.Optimizer:
        return self.cls(list(params), lr=float(self.schedule(0)), **self.kwargs)

    def step(self, opt: torch.optim.Optimizer, count: int) -> float:
        lr = float(self.schedule(count))
        for group in opt.param_groups:
            group["lr"] = lr
        if self.grad_clip_norm:
            torch.nn.utils.clip_grad_norm_(
                [p for g in opt.param_groups for p in g["params"]], self.grad_clip_norm)
        opt.step()
        return lr


def build_optimizer(config: dict) -> Optimizer:
    """An ``Optimizer`` from the JAX package's config dict:

    ``{"optimizer": {"name": "adamw", "lr": 1e-3, "betas": (0.9, 0.9),
    "weight_decay": 0.0} | "adam", "lr_scheduler": {"scheduler": {"name":
    "cosine_annealing_lr", "t_max": 200, "eta_min": 1e-7}} | None,
    "grad_clip_norm": float | None}``, or the flat ``{"name": ..., "lr": ...}``.
    """
    cfg = dict(config)
    opt_cfg = cfg.get("optimizer", cfg)
    if isinstance(opt_cfg, str):
        opt_cfg = {"name": opt_cfg}
    opt_cfg = dict(opt_cfg)
    name = opt_cfg.pop("name")
    lr = opt_cfg.pop("lr", opt_cfg.pop("learning_rate", 1e-3))
    if "betas" in opt_cfg:
        opt_cfg["b1"], opt_cfg["b2"] = opt_cfg.pop("betas")
    if cfg.get("freeze"):
        raise NotImplementedError(f"freeze is not ported ({_ITEM})")
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported ({_ITEM})")
    spec = cfg.get("lr_scheduler")
    if isinstance(spec, dict) and "scheduler" in spec:
        spec = spec["scheduler"]
    if isinstance(spec, dict) and "plateau" in str(spec.get("name", "")):
        raise NotImplementedError(f"the plateau scheduler is not ported ({_ITEM})")
    kwargs = {k: v for k, v in opt_cfg.items()
              if k in ("b1", "b2", "eps", "weight_decay") and v is not None}
    cls, torch_kwargs = OPTIMIZERS.build(name, **kwargs)
    return Optimizer(cls, torch_kwargs, build_schedule(lr, spec), cfg.get("grad_clip_norm"))
