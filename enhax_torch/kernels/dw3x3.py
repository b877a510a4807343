"""A depthwise 3x3 on its own: the CUDA kernel for Hopper and its plain version.

Port of the dw-only roofline probe's kernel (``run/probe_dw_roofline.py``,
``dw_kernel``): a bias-free depthwise 3x3 over NHWC x with taps (3, 3, C),
summed in float32, the output in x's dtype. ``rows="zero"`` is SAME zero
padding (the probe's ``dw_base`` and ``dw_fma``, one function);
``rows="edge"`` repeats the first and last image rows above and below and
zero-pads W (``dw_nomask``, whose clamped halo rows are left unmasked).

A tensor on the CPU goes to ``dw3x3_plain``; a CUDA tensor goes to the kernel
(``csrc/dw3x3.cu``), or the wrapper raises (also where autograd would record
the call). ``dw3x3_apply.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import launch_error, refuse_grad

ROWS = ("zero", "edge")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def dw3x3_plain(x: torch.Tensor, k: torch.Tensor, rows: str = "zero") -> torch.Tensor:
    """The plain version: the nine taps summed in float32 over dx, then dh
    (the probe kernel's order), stored once in x's dtype."""
    _check_rows(rows)
    xf = x.float()
    if rows == "edge":
        xf = torch.cat([xf[:, :1], xf, xf[:, -1:]], dim=1)
    else:
        xf = F.pad(xf, (0, 0, 0, 0, 1, 1))
    xf = F.pad(xf, (0, 0, 1, 1))
    h, w = x.shape[1], x.shape[2]
    kf = k.float()
    acc = None
    for dx in range(3):
        for dh in range(3):
            t = xf[:, dh:dh + h, dx:dx + w] * kf[dh, dx]
            acc = t if acc is None else acc + t
    return acc.to(x.dtype)


def _check_rows(rows: str) -> None:
    if rows not in ROWS:
        raise ValueError(f"dw3x3: rows must be one of {ROWS}, got {rows!r}")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dw3x3")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dw3x3_apply.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.dw3x3_apply.restype = i32
    return lib


def dw3x3_apply(x: torch.Tensor, k: torch.Tensor, rows: str = "zero") -> torch.Tensor:
    """Depthwise 3x3 of NHWC ``x`` with taps ``k`` (3, 3, C), as ``dw3x3_plain``."""
    _check_rows(rows)
    if x.ndim != 4 or tuple(k.shape) != (3, 3, x.shape[-1]):
        raise ValueError(f"dw3x3_apply: x {tuple(x.shape)} and taps {tuple(k.shape)} "
                         "are not NHWC and (3, 3, C)")
    if k.device != x.device:
        raise ValueError(f"dw3x3_apply: x on {x.device}, taps on {k.device}")
    if x.device.type == "cpu":
        return dw3x3_plain(x, k, rows)
    if x.device.type != "cuda":
        raise ValueError(f"dw3x3_apply: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dw3x3_apply: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dw3x3_apply: x is not contiguous")
    refuse_grad("dw3x3_apply", x, k)
    b, h, w, c = x.shape
    if b > _MAX_GRID_YZ or h * w * c > 2**31 - 1:
        raise ValueError(f"dw3x3_apply: x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    kf = k.detach().float().contiguous()
    vec = int(c % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().dw3x3_apply(x.data_ptr(), kf.data_ptr(), out.data_ptr(),
                                 _DTYPE_CODES[x.dtype], b, h, w, c, ROWS.index(rows), vec,
                                 stream)
    if err:
        raise launch_error("dw3x3_apply", err)
    dw3x3_apply.launches += 1
    return out


dw3x3_apply.launches = 0
