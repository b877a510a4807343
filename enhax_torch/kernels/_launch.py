"""Checks shared by the kernel wrappers around a launch."""

from __future__ import annotations

import weakref

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


def aligned16(fn: str, tensors: dict) -> None:
    """Raise unless every base is 16-byte aligned: the kernels' forms that
    copy 16 bytes at a time (``cp.async``) take no other."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


_PREPARED: dict = {}


def prepared(kind: str, tensors: tuple, make):
    """``make(*tensors)``, computed once and kept while ``tensors`` are the
    same tensors, on the same storage, at the same version: an in-place
    update of any of them (``load_state_dict``, ``copy_``) or a cast that
    gives it new storage (``module.to``) prepares anew. An entry is keyed
    on ``kind`` and the first tensor and dropped when that tensor is freed.
    Inference tensors carry no version and are prepared on every call.
    ``prepared.makes`` counts the calls of ``make``."""
    if any(t.is_inference() for t in tensors):
        prepared.makes += 1
        return make(*tensors)
    sig = tuple((t.data_ptr(), t._version) for t in tensors)
    key = (kind, id(tensors[0]))
    hit = _PREPARED.get(key)
    if hit is not None and hit[0]() is tensors[0] and hit[1] == sig:
        return hit[2]
    prepared.makes += 1
    value = make(*tensors)
    if hit is None or hit[0]() is not tensors[0]:
        weakref.finalize(tensors[0], _PREPARED.pop, key, None)
    _PREPARED[key] = (weakref.ref(tensors[0]), sig, value)
    return value


prepared.makes = 0
