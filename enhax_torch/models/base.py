"""Model abstraction of the port.

Port of ``enhax/models/base.py``. A ``Model`` bundles an ``nn.Module`` with
the registry metadata and the datapoint contract of the JAX package:
``apply(datapoint) -> outputs dict``, where a datapoint is a dict of NHWC
images in [0, 1] (``image`` in) and the outputs carry ``out_key``
(``enhanced``). Unlike the JAX package the weights live in the module.

A model may carry a fused path, ``fast_apply_fn(module, *inputs)``
(NAFNet's hand-written NAFBlock kernels). ``apply`` takes it for inference
on a CUDA tensor, the port's form of the JAX gate on the TPU backend, and
for training where the caller asks for it with ``fused=True``, the port's
form of the JAX package's ``ENHAX_FUSED_TRAIN=1`` (an argument: the package
reads no environment switch). Otherwise the module's own forward runs.

``loss_fn(outputs, datapoint) -> scalar`` is the model's training loss;
``forward_loss`` runs a training forward and takes it, or calls
``forward_loss_fn(model, datapoint) -> (loss, outputs)`` where a model's
loss needs more than one forward (ZSN2N's pair-downsample consistency).
``optional_inputs`` are datapoint keys passed to the module as keywords
when present (a depth map).

A module whose forward takes ``train`` (AirNet's BatchNorms) normalises
with its batch's statistics and updates its running ones only where
``apply(..., batch_stats=True)`` passes ``train=True``: the port's form of
the JAX package's ``apply_train``, which its trainer takes on a float32
step with a plain ``loss_fn``. Every other forward, ``forward_loss`` and
serving included, normalises with the running statistics.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card raises:
    the port never falls back to the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class Model:
    """An ``nn.Module`` + metadata.

    Attributes:
        name/arch/tasks/schemes: registry metadata.
        module: maps the required input images (NHWC) to an outputs dict.
        required_inputs: datapoint keys the model consumes.
        out_key: primary output key (``enhanced`` for enhancement models).
        instance_steps: >0 marks per-image test-time optimization models
            (``Predictor`` fits ``instance_steps`` Adam steps of lr
            ``instance_lr``, AdamW with ``instance_weight_decay``).
        size_divisor: H/W multiple the engine pads inputs to.
        fast_apply_fn: optional fused path ``(module, *inputs, training=False)
            -> outputs``, taken by ``apply``.
        loss_fn: ``(outputs, datapoint) -> scalar`` (None: inference only).
        optional_inputs: datapoint keys forwarded to the module as keywords
            when present.
        forward_loss_fn: ``(model, datapoint) -> (loss, outputs)``, taken
            by ``forward_loss`` in place of one forward and ``loss_fn``.
    """

    name: str
    arch: str
    module: nn.Module
    tasks: tuple = (Task.LLIE,)
    schemes: tuple = (Scheme.SUPERVISED,)
    required_inputs: tuple = ("image",)
    out_key: str = "enhanced"
    instance_steps: int = 0
    instance_lr: float = 1e-4
    instance_weight_decay: float = 0.0
    size_divisor: int = 32
    scale: int = 1   # spatial output/input ratio (SR models > 1)
    fast_apply_fn: Callable | None = None
    loss_fn: Callable | None = None
    optional_inputs: tuple = ()
    forward_loss_fn: Callable | None = None

    def apply(self, datapoint: dict, training: bool = False, fused: bool = False,
              batch_stats: bool = False) -> dict:
        """Forward: datapoint dict -> outputs dict.

        Inference on a CUDA tensor takes ``fast_apply_fn`` where the model
        has one. Training takes it only with ``fused=True``: on the card the
        kernels run forward and the eager block math backward; on the CPU
        their plain versions do. Otherwise the module's forward runs; with
        ``batch_stats`` and a module that ``accepts_train``, on its batch's
        statistics (``train=True``)."""
        inputs = [datapoint[k] for k in self.required_inputs]
        kwargs = {k: datapoint[k] for k in self.optional_inputs
                  if datapoint.get(k) is not None}
        if batch_stats and self.accepts_train:
            out = self.module(*inputs, train=True, **kwargs)
        elif training and fused:
            if self.fast_apply_fn is None:
                raise ValueError(f"model {self.name} has no fused path to train through")
            out = self.fast_apply_fn(self.module, *inputs, training=True)
        elif self.fast_apply_fn is not None and not training and inputs[0].is_cuda:
            out = self.fast_apply_fn(self.module, *inputs)
        else:
            out = self.module(*inputs, **kwargs)
        if isinstance(out, dict):
            return out
        return {self.out_key: out}

    @property
    def accepts_train(self) -> bool:
        """Whether the module's forward takes ``train`` (BatchNorms that
        normalise with the batch's statistics when it is set)."""
        return "train" in inspect.signature(self.module.forward).parameters

    @property
    def trains_fused(self) -> bool:
        """Whether the fused path has a training form: ``fast_apply_fn``
        takes ``training`` (NAFNet's; Restormer's serves only)."""
        return (self.fast_apply_fn is not None
                and "training" in inspect.signature(self.fast_apply_fn).parameters)

    def forward_loss(self, datapoint: dict, fused: bool = False) -> tuple:
        """(loss, outputs) of a training forward."""
        if self.forward_loss_fn is not None:
            return self.forward_loss_fn(self, datapoint)
        if self.loss_fn is None:
            raise ValueError(f"model {self.name} has no loss")
        outputs = self.apply(datapoint, training=True, fused=fused)
        return self.loss_fn(outputs, datapoint), outputs

    def to(self, device=None, dtype=None) -> "Model":
        """Move (and cast) the module's parameters in place."""
        self.module.to(device=device, dtype=dtype)
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype; float32 for a parameter-free model (LIME,
        PIE), which computes in its input's."""
        p = next(self.module.parameters(), None)
        return torch.float32 if p is None else p.dtype

    # -- contracts -----------------------------------------------------------

    def assert_datapoint(self, datapoint: dict) -> None:
        for k in self.required_inputs:
            if k not in datapoint or datapoint[k] is None:
                raise ValueError(
                    f"model {self.name} requires datapoint key {k!r}; "
                    f"got {sorted(datapoint)}")

    def assert_outputs(self, outputs: dict) -> None:
        if self.out_key not in outputs:
            raise ValueError(
                f"model {self.name} must produce {self.out_key!r}; "
                f"got {sorted(outputs)}")

    def param_count(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


def build_model(name: str, device="cuda", dtype: torch.dtype = torch.float32,
                seed: int = 0, **kwargs) -> Model:
    """Build a registered model by name, with weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    model = MODELS.build(name, generator=generator, **kwargs)
    return model.to(device=dev, dtype=dtype)
