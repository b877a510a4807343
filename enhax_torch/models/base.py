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
``forward_loss`` runs a training forward and takes it.
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
        instance_steps: >0 marks per-image test-time optimization models.
        size_divisor: H/W multiple the engine pads inputs to.
        fast_apply_fn: optional fused path ``(module, *inputs, training=False)
            -> outputs``, taken by ``apply``.
        loss_fn: ``(outputs, datapoint) -> scalar`` (None: inference only).
    """

    name: str
    arch: str
    module: nn.Module
    tasks: tuple = (Task.LLIE,)
    schemes: tuple = (Scheme.SUPERVISED,)
    required_inputs: tuple = ("image",)
    out_key: str = "enhanced"
    instance_steps: int = 0
    size_divisor: int = 32
    scale: int = 1   # spatial output/input ratio (SR models > 1)
    fast_apply_fn: Callable | None = None
    loss_fn: Callable | None = None

    def apply(self, datapoint: dict, training: bool = False, fused: bool = False) -> dict:
        """Forward: datapoint dict -> outputs dict.

        Inference on a CUDA tensor takes ``fast_apply_fn`` where the model
        has one. Training takes it only with ``fused=True``: on the card the
        kernels run forward and the eager block math backward; on the CPU
        their plain versions do. Otherwise the module's forward runs."""
        inputs = [datapoint[k] for k in self.required_inputs]
        if training and fused:
            if self.fast_apply_fn is None:
                raise ValueError(f"model {self.name} has no fused path to train through")
            out = self.fast_apply_fn(self.module, *inputs, training=True)
        elif self.fast_apply_fn is not None and not training and inputs[0].is_cuda:
            out = self.fast_apply_fn(self.module, *inputs)
        else:
            out = self.module(*inputs)
        if isinstance(out, dict):
            return out
        return {self.out_key: out}

    @property
    def trains_fused(self) -> bool:
        """Whether the fused path has a training form: ``fast_apply_fn``
        takes ``training`` (NAFNet's; Restormer's serves only)."""
        return (self.fast_apply_fn is not None
                and "training" in inspect.signature(self.fast_apply_fn).parameters)

    def forward_loss(self, datapoint: dict, fused: bool = False) -> tuple:
        """(loss, outputs) of a training forward."""
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
        return next(self.module.parameters()).dtype

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
