"""Checks shared by the kernel wrappers around a launch."""

from __future__ import annotations

import torch


def refuse_grad(fn: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record the call: a kernel launched through
    ctypes writes a fresh tensor that has no ``grad_fn``, so its result would
    be cut from the graph without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{fn}: the CUDA kernel has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode(), or on CPU "
                           "tensors, whose plain version is differentiable")


def launch_error(fn: str, err: int) -> RuntimeError:
    return RuntimeError(f"{fn}: kernel launch failed with cudaError_t {err}")
