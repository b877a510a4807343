"""The fit loop and the train and eval steps.

Port of ``enhax/train/trainer.py``. The JAX package's jitted step maps
``(state, batch) -> (state, metrics)`` over a pytree of params; here the
``nn.Module``'s parameters are the master weights, the optimizer state is a
``torch.optim`` object, and a step updates both in place:

  * the loss is ``model.loss_fn`` of a training forward, then
    ``loss.backward()`` and the optimizer's step with the scheduled lr of
    the step count before it (``nn.optim.Optimizer.step``);
  * ``remat`` wraps forward + loss in ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint(loss_fn)``: the forward runs again in the
    backward);
  * ``precision="bf16"`` / ``"bf16-mixed"``: bf16 copies of the parameters
    (``p.to(torch.bfloat16)``, which autograd carries back to the float32
    masters) and of the batch, a forward through
    ``torch.func.functional_call``, the outputs cast to float32 and the loss
    taken against the float32 batch. Parameters, optimizer state, loss and
    metrics stay float32. Not ``torch.autocast``: autocast rounds at other
    places than the JAX package's cast of params and batch, and leaves the
    kernels' inputs as they come. Under ``remat`` the copies are made
    outside the checkpoint, so the recomputed forward sees the same tensors
    (and the kernels' prepared weights are reused within a step);
  * ``ema_decay``: after the update, ``shadow = decay * shadow + (1 - decay)
    * param`` over the named parameters, buffers copied (BasicSR's
    ``net_g_ema``); eval and the ``best`` checkpoint use the shadow;
  * ``fused``: the training forward through the model's fused path
    (``Model.apply(..., fused=True)``), the port's ``ENHAX_FUSED_TRAIN=1``;
  * BatchNorm statistics (a module that ``accepts_train``, AirNet's): a
    float32 step of a model with a plain ``loss_fn`` runs the module on the
    batch's statistics and updates the running ones
    (``Model.apply(..., batch_stats=True)``), as the JAX package's step
    takes ``apply_train`` there; in bf16-mixed, and for a model with
    ``forward_loss_fn``, the running statistics normalise and stay as they
    are. Under ``remat`` the recomputed forward updates them a second time,
    so the step puts back the values of the first forward after the
    backward. They are buffers: no optimizer steps them;
  * ``accumulate_grad_batches=k``: optax's ``MultiSteps`` around the
    optimizer and the clip: each mini-batch's gradient adds into ``.grad``,
    and at the k-th the mean is clipped and the optimizer steps; the
    schedule counts those updates, ``state.step`` counts mini-batches, and
    the EMA updates after every mini-batch, as the JAX package's step does.
    A checkpoint saved inside a cycle keeps the sum in ``.grad`` (as
    ``MultiSteps`` keeps its ``acc_grads``), so a resumed run finishes the
    cycle on the gradients of all its mini-batches.

``Trainer.fit`` calls its hooks (``train/hooks.py``) after each epoch's CSV
write and before its checkpoint, and steps the plateau scheduler on its
monitor there, writing the new lr into the optimizer (``row["lr"]``).

The loop synchronises with the device only where it reads a value back: the
log line every ``log_every_n_steps`` and the epoch means. The step's parts
are ``torch.profiler`` ranges (``train_step.forward``, ``.backward``,
``.optimizer``, ``.ema``), which a profiler's table splits the step by.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import signal
import time
from pathlib import Path
from typing import Any, Callable

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from enhax_torch.data.datamodule import prefetch_to_device
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import statistics_parameters
from enhax_torch.nn.metrics import psnr, ssim
from enhax_torch.nn.optim import Optimizer, build_optimizer_with_plateau, set_opt_learning_rate
from enhax_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint

BF16_PRECISIONS = ("bf16", "bf16-mixed", "16-mixed", "16", 16)


@dataclasses.dataclass
class TrainState:
    """The step count, the module (its parameters are the master weights),
    the ``torch.optim`` object over its trainable parameters, the EMA
    shadow (a copy of the module) when training with ``ema_decay``, and the
    mini-batches a cycle of gradient accumulation takes (a checkpoint saved
    inside a cycle keeps the gradients summed so far)."""

    step: int
    module: nn.Module
    optimizer: torch.optim.Optimizer
    ema: nn.Module | None = None
    accumulate_grad_batches: int = 1


class _Forward(nn.Module):
    """``model.apply`` (or, for a model with ``forward_loss_fn``,
    ``model.forward_loss``) as a module, so that ``functional_call`` can run
    it on substituted (bf16) parameters, the fused path included."""

    def __init__(self, model: Model, fused: bool):
        super().__init__()
        self.net = model.module   # the parameters' names gain "net."
        self.model = model
        self.fused = fused

    def forward(self, batch: dict):
        if self.model.forward_loss_fn is not None:
            return self.model.forward_loss(batch)
        return self.model.apply(batch, training=True, fused=self.fused)


def _cast_floats(tree: dict, dtype: torch.dtype) -> dict:
    return {k: v.to(dtype) if v is not None and v.is_floating_point() else v
            for k, v in tree.items()}


def _clip(params: list, value: float | None, algorithm: str) -> None:
    if not value:
        return
    if algorithm == "norm":
        torch.nn.utils.clip_grad_norm_(params, value)
    elif algorithm == "value":
        torch.nn.utils.clip_grad_value_(params, value)
    else:
        raise ValueError(f"gradient_clip_algorithm must be 'norm' or 'value', got {algorithm!r}")


@torch.no_grad()
def update_ema(ema: nn.Module, module: nn.Module, decay: float) -> None:
    """shadow = decay * shadow + (1 - decay) * param; buffers copied."""
    shadow = [p for _, p in ema.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, params, alpha=1.0 - decay)
    for b_ema, b in zip(ema.buffers(), module.buffers()):
        b_ema.copy_(b)


def make_train_step(model: Model, tx: Optimizer, remat: bool = False,
                    precision: str | None = None, ema_decay: float | None = None,
                    fused: bool = False, gradient_clip_val: float | None = None,
                    gradient_clip_algorithm: str = "norm",
                    accumulate_grad_batches: int = 1) -> Callable:
    """The train step: ``step(state, batch) -> metrics``, updating ``state``
    in place. ``batch`` holds tensors on the module's device; the metrics
    (``loss``, and ``psnr`` of clip(enhanced, 0, 1) against ``ref_image``)
    are 0-dim float32 tensors, left on the device. With
    ``accumulate_grad_batches=k`` the optimizer steps on every k-th call,
    on the mean of the k gradients."""
    if model.loss_fn is None and model.forward_loss_fn is None:
        raise ValueError(f"model {model.name} has no loss to train on")
    k = max(int(accumulate_grad_batches or 1), 1)
    use_bf16 = precision in BF16_PRECISIONS
    forward = _Forward(model, fused)
    bn_path = (not use_bf16 and model.forward_loss_fn is None and model.loss_fn is not None
               and model.accepts_train)

    def loss_of(params16, batch16, batch):
        if bn_path:
            outputs = model.apply(batch, training=True, batch_stats=True)
            return model.loss_fn(outputs, batch), outputs
        if params16 is None:
            return model.forward_loss(batch, fused=fused)
        if model.forward_loss_fn is not None:
            # a multi-forward loss runs in bf16 throughout, the scalar upcast
            loss, outputs = torch.func.functional_call(forward, params16, (batch16,))
            return loss.float(), _cast_floats(outputs, torch.float32)
        outputs = torch.func.functional_call(forward, params16, (batch16,))
        outputs = _cast_floats(outputs, torch.float32)
        return model.loss_fn(outputs, batch), outputs

    def step(state: TrainState, batch: dict) -> dict:
        for key in model.required_inputs:
            if key not in batch:
                # the JAX package's trainer reads them at its init
                raise KeyError(key)
        module, opt = state.module, state.optimizer
        mini = state.step % k
        if mini == 0:
            opt.zero_grad(set_to_none=True)
        params16 = batch16 = None
        if use_bf16:
            params16 = {f"net.{k}": p.to(torch.bfloat16) for k, p in module.named_parameters()}
            batch16 = _cast_floats(batch, torch.bfloat16)
        with record_function("train_step.forward"):
            if remat:
                loss, outputs = checkpoint(loss_of, params16, batch16, batch,
                                           use_reentrant=False)
            else:
                loss, outputs = loss_of(params16, batch16, batch)
        stats = ([(b, b.clone()) for b in module.buffers()] if remat and bn_path else [])
        with record_function("train_step.backward"):
            loss.backward()
        with torch.no_grad():
            for b, first in stats:   # the recompute's second update undone
                b.copy_(first)
        if mini == k - 1:
            with record_function("train_step.optimizer"):
                params = [p for g in opt.param_groups for p in g["params"]]
                if k > 1:
                    grads = [p.grad for p in params if p.grad is not None]
                    torch._foreach_div_(grads, float(k))
                _clip(params, gradient_clip_val, gradient_clip_algorithm)
                tx.step(opt, state.step // k)
        if ema_decay and state.ema is not None:
            with record_function("train_step.ema"):
                update_ema(state.ema, module, ema_decay)
        metrics = {"loss": loss.detach().float()}
        if "ref_image" in batch and model.out_key in outputs:
            with torch.no_grad():
                pred = outputs[model.out_key].detach().float().clamp(0.0, 1.0)
                metrics["psnr"] = psnr(pred, batch["ref_image"])
        state.step += 1
        return metrics

    return step


def make_eval_step(model: Model, compute_ssim: bool = True) -> Callable:
    """The eval step: ``step(module, batch) -> metrics`` (``psnr``, ``ssim``
    and ``loss``) under ``torch.inference_mode()``; on the card the model's
    serving path (its fused kernels) runs."""

    def step(module: nn.Module, batch: dict) -> dict:
        m = dataclasses.replace(model, module=module)
        with torch.inference_mode():
            outputs = m.apply(batch)
            metrics = {}
            if "ref_image" in batch and model.out_key in outputs:
                pred = outputs[model.out_key].float().clamp(0.0, 1.0)
                ref = batch["ref_image"].float()
                metrics["psnr"] = psnr(pred, ref)
                if compute_ssim:
                    metrics["ssim"] = ssim(pred, ref)
            if model.loss_fn is not None:
                try:
                    metrics["loss"] = model.loss_fn(outputs, batch).float()
                except KeyError as e:
                    # a val batch without the loss's inputs: omit the
                    # metric, and say so
                    print(f"[trainer] val loss for {model.name} needs {e}; omitted")
        return metrics

    return step


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


class Trainer:
    """The training loop (the JAX package's ``Trainer``).

    Args:
        model: a ``Model`` whose module sits on the device to train on.
        optimizer: an ``nn.optim.Optimizer`` or the JAX package's config dict.
        max_epochs/max_steps: stop conditions.
        ckpt_dir: checkpoint directory (``last`` and ``best``); ``monitor``
            ("psnr", "max") picks ``best`` on ``val/<name>``.
        log_every_n_steps, save_dir: the log line and the CSV log.
        remat, precision, ema_decay, gradient_clip_val,
        gradient_clip_algorithm: the step's (``make_train_step``).
        limit_train_batches, limit_val_batches, overfit_batches,
        fast_dev_run: the debug knobs.
        fused_train: train through the model's fused path.
        hooks: ``hook(trainer, state, row)`` after each epoch
            (``train/hooks.py``).
        accumulate_grad_batches: the optimizer steps every k mini-batches.
        log_image_every_n_epochs: stored; as in the JAX package nothing reads
            it (``DebugImageHook`` writes images).
    The JAX surface's ``mesh`` / ``strategy`` raise ``NotImplementedError``
    (ROADMAP item 1.14).
    """

    def __init__(self, model: Model, optimizer, max_epochs: int = 100,
                 max_steps: int | None = None, mesh=None, strategy: str | None = None,
                 ckpt_dir=None, monitor: tuple = ("psnr", "max"),
                 log_every_n_steps: int = 50, log_image_every_n_epochs: int = 0,
                 save_dir=None, hooks: list | None = None,
                 remat: bool = False, gradient_clip_val: float | None = None,
                 gradient_clip_algorithm: str = "norm", accumulate_grad_batches: int = 1,
                 limit_train_batches: int | None = None, limit_val_batches: int | None = None,
                 overfit_batches: int = 0, fast_dev_run: bool = False,
                 precision: str | None = None, ema_decay: float | None = None,
                 fused_train: bool = False):
        if mesh is not None or strategy is not None:
            raise _not_ported("a device mesh / --strategy", "1.14")
        self.model = model
        self.plateau = self.plateau_monitor = None
        if isinstance(optimizer, dict):
            optimizer, self.plateau, self.plateau_monitor = \
                build_optimizer_with_plateau(optimizer)
        self.tx = optimizer
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.log_every_n_steps = log_every_n_steps
        self.log_image_every_n_epochs = log_image_every_n_epochs
        self.save_dir = save_dir
        self.hooks = list(hooks or [])
        self.history: list[dict] = []
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.overfit_batches = overfit_batches
        if fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1
        self.ema_decay = ema_decay
        self.precision = precision
        self.accumulate_grad_batches = max(int(accumulate_grad_batches or 1), 1)
        self._train_step = make_train_step(
            model, self.tx, remat=remat, precision=precision, ema_decay=ema_decay,
            fused=fused_train, gradient_clip_val=gradient_clip_val,
            gradient_clip_algorithm=gradient_clip_algorithm,
            accumulate_grad_batches=accumulate_grad_batches)
        self._eval_step = make_eval_step(model)
        self._preempted = False

    @property
    def device(self) -> torch.device:
        return next(self.model.module.parameters()).device

    def init_state(self) -> TrainState:
        """Step 0: the optimizer over the trainable parameters (BatchNorm
        statistics held as parameters stay as they are, as the JAX package
        keeps ``batch_stats`` out of its optimizer), the EMA shadow a copy of
        the initial parameters."""
        module = self.model.module
        ema = copy.deepcopy(module).requires_grad_(False) if self.ema_decay else None
        stats = statistics_parameters(module)
        trainable = [(n, p) for n, p in module.named_parameters()
                     if p.requires_grad and id(p) not in stats]
        return TrainState(step=0, module=module, optimizer=self.tx.init(trainable), ema=ema,
                          accumulate_grad_batches=self.accumulate_grad_batches)

    def fit(self, train_iter_fn: Callable[[], Any], val_iter_fn=None,
            state: TrainState | None = None, resume: bool = True) -> TrainState:
        """Run the loop. ``train_iter_fn()`` gives a fresh iterable of numpy
        NHWC batch dicts an epoch; they are moved to the device on a
        background thread (``prefetch_to_device``)."""
        start_epoch = 0
        if state is None:
            # the JAX package draws its first batch here to build the state;
            # the call advances the DataModule's epoch counter, so each epoch
            # shuffles as the JAX package's does
            train_iter_fn()
            state = self.init_state()
            if resume and self.ckpt_dir:
                ck = latest_checkpoint(self.ckpt_dir)
                if ck:
                    state, start_epoch = load_checkpoint(ck, state)
                    print(f"[trainer] resumed from {ck} at step {state.step} "
                          f"(epoch {start_epoch})")
        best = None
        sign = 1.0 if self.monitor[1] == "max" else -1.0
        t0 = time.perf_counter()

        def on_sigterm(signum, frame):
            self._preempted = True
            print("[trainer] SIGTERM received: will checkpoint and stop")

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            prev_handler = None  # not the main thread

        overfit_cache = None
        try:
            for epoch in range(start_epoch, self.max_epochs):
                if self.overfit_batches:
                    if overfit_cache is None:
                        it = iter(train_iter_fn())
                        overfit_cache = [b for _, b in zip(range(self.overfit_batches), it)]
                    batches = overfit_cache
                else:
                    batches = train_iter_fn()
                epoch_metrics = []
                with contextlib.closing(prefetch_to_device(batches, self.device)) as it:
                    for bi, batch in enumerate(it):
                        if self.limit_train_batches is not None and bi >= self.limit_train_batches:
                            break
                        metrics = self._train_step(state, batch)
                        if self.max_steps and state.step >= self.max_steps:
                            break
                        if state.step % self.log_every_n_steps == 0:
                            print(f"[epoch {epoch}] step {state.step}: " + " ".join(
                                f"{k}={v.item():.4f}" for k, v in metrics.items()))
                        epoch_metrics.append(metrics)

                row = {"epoch": epoch, "step": state.step, "time": time.perf_counter() - t0}
                row.update({f"train/{k}": v for k, v in _means(epoch_metrics).items()})
                if val_iter_fn is not None:
                    eval_module = state.ema if state.ema is not None else state.module
                    vit = val_iter_fn()
                    if self.limit_val_batches is not None:
                        vit = (b for _, b in zip(range(self.limit_val_batches), iter(vit)))
                    with contextlib.closing(prefetch_to_device(vit, self.device)) as it:
                        vals = [self._eval_step(eval_module, b) for b in it]
                    row.update({f"val/{k}": v for k, v in _means(vals).items()})
                if self.plateau is not None and self.plateau_monitor in row:
                    row["lr"] = self.plateau.step(row[self.plateau_monitor])
                    set_opt_learning_rate(state.optimizer, row["lr"])
                self.history.append(row)
                self._write_csv_log()
                for hook in self.hooks:
                    hook(self, state, row)

                if self.ckpt_dir:
                    score = row.get(f"val/{self.monitor[0]}")
                    save_checkpoint(self.ckpt_dir, state, epoch, name="last")
                    if score is not None and (best is None or sign * score > sign * best):
                        best = score
                        save_checkpoint(self.ckpt_dir, state, epoch, name="best")

                if self.max_steps and state.step >= self.max_steps:
                    break
                # hooks may lower max_epochs (EarlyStopHook): range() above
                # holds the bound it started with
                if epoch + 1 >= self.max_epochs:
                    break
                if self._preempted:
                    if self.ckpt_dir:
                        save_checkpoint(self.ckpt_dir, state, epoch, name="last")
                        print("[trainer] preemption checkpoint saved")
                    break
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state

    def _write_csv_log(self):
        if not self.save_dir or not self.history:
            return
        path = Path(self.save_dir) / "log.csv"
        path.parent.mkdir(parents=True, exist_ok=True)
        keys = sorted({k for row in self.history for k in row})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.history)


def _means(metrics: list[dict]) -> dict:
    """The mean of each metric over the list, read back as Python floats
    (one synchronisation with the device)."""
    if not metrics:
        return {}
    stacked = {k: torch.stack([m[k].float() for m in metrics]).mean() for k in metrics[0]}
    return dict(zip(stacked, torch.stack(list(stacked.values())).tolist()))
