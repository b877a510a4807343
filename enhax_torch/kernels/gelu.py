"""The exact GELU on its own: the CUDA kernel for Hopper and its plain version.

Port of the GELU probe's kernel (``run/probe_gelu_kernel.py``,
``gelu_kernel``): 0.5 x (1 + erf(x / sqrt 2)) on float32 with one of the two
polynomial erfs the TPU kernels chose between, with the probe's coefficients
and order of operations: ``erf="as"`` (Abramowitz-Stegun 7.1.26, one exp and
one divide; the JAX package's ``_gelu_erf``) or ``erf="rational"`` (an odd
rational function of z on clamp(z, -4, 4), one divide).

A tensor on the CPU goes to ``gelu_plain``; a CUDA tensor goes to the kernel
(``csrc/gelu.cu``), or the wrapper raises (also where autograd would record
the call). ``gelu_apply.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import launch_error, refuse_grad

ERFS = ("as", "rational")
_SQRT_HALF = 0.7071067811865476


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 (|error| <= 1.5e-7), the probe's ``erf_as``."""
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(z) * (1.0 - poly * torch.exp(-a * a))


def erf_rational(z: torch.Tensor) -> torch.Tensor:
    """z P5(z^2) / Q4(z^2) on clamp(z, -4, 4), the probe's ``erf_rat``."""
    z = z.clamp(-4.0, 4.0)
    s = z * z
    p = 4.541595940311584e-06 + s * -1.2470351406334228e-08
    p = 0.00037391180030277586 + s * p
    p = 0.0038262388474131987 + s * p
    p = 0.05417170777013625 + s * p
    p = 0.18505783362438136 + s * p
    p = 1.1283791749554233 + s * p
    q = 0.0012949563768775315 + s * 6.173045363623838e-05
    q = 0.015397154870790184 + s * q
    q = 0.11378662606783872 + s * q
    q = 0.4973367187815083 + s * q
    return z * p / (1.0 + s * q)


def gelu_plain(x: torch.Tensor, erf: str = "as") -> torch.Tensor:
    """The plain version, in x's dtype (float32 on the kernel's path)."""
    fn = _erf(erf)
    return 0.5 * x * (1.0 + fn(x * _SQRT_HALF))


def _erf(erf: str):
    if erf not in ERFS:
        raise ValueError(f"gelu: erf must be one of {ERFS}, got {erf!r}")
    return erf_as if erf == "as" else erf_rational


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gelu")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gelu_apply.argtypes = [vp, vp, i64, i32, i32, vp]
    lib.gelu_apply.restype = i32
    return lib


def gelu_apply(x: torch.Tensor, erf: str = "as") -> torch.Tensor:
    """GELU of float32 ``x`` (any shape) with the ``erf`` form, as ``gelu_plain``."""
    _erf(erf)
    if x.device.type == "cpu":
        return gelu_plain(x, erf)
    if x.device.type != "cuda":
        raise ValueError(f"gelu_apply: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"gelu_apply: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gelu_apply: x is not contiguous")
    refuse_grad("gelu_apply", x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gelu_apply(x.data_ptr(), out.data_ptr(), x.numel(), ERFS.index(erf), vec,
                                stream)
    if err:
        raise launch_error("gelu_apply", err)
    gelu_apply.launches += 1
    return out


gelu_apply.launches = 0
