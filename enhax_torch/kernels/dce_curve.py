"""Zero-DCE curve application: CUDA kernels for Hopper and their plain versions.

Port of ``enhax/kernels/dce_curve.py``. The curve loop
``y <- y + r_i * (y^2 - y)`` is elementwise but iterative: run as separate
ops, every iteration reads y and its curve from device memory and writes y
back. The kernels (``csrc/dce_curve.cu``) keep y in registers for all
iterations, so the traffic is: read image once, read curves once, write
output once. ``fused_curve_upsample_apply`` also takes the curve at 1/s
resolution and interpolates it in the kernel, so the full-resolution curve
never reaches device memory.

Each wrapper takes NHWC contiguous float32 or bfloat16 tensors. A tensor on
the CPU goes to the plain PyTorch version beside the kernel; a CUDA tensor
goes to the kernel, or the wrapper raises; it raises too where autograd
would record the call (the kernels have no backward). Each wrapper counts
its kernel launches in its ``launches`` attribute.

The upsample kernel has two paths, picked by ``upsample_path`` from the
shape, the dtype, the scale and the image's address before the launch:
``"vec"`` (C = 3, scale 2, 4 or 8, W a multiple of 8, 16-byte rows and base:
a thread owns 8 pixels and walks down a band of rows, a warp 32 such groups
of one row) and ``"general"``
(any C and scale). ``fused_curve_upsample_apply.path_launches`` counts each
path's launches.

The apply kernel has two paths as well, picked by ``apply_path`` from the
shape, the form (shared or per iteration), the number of iterations and the
three bases before the launch: ``"vec"`` (image, curves and output 16-byte
aligned; a shared curve of any C: a flat pass of 16-byte vectors; or
per-iteration curves at C = 3 with 8 iterations, the count every Zero-DCE
config sends: a warp's span of pixels through shared memory, 48 bytes of
the image a thread) and ``"general"`` (any C, iterations and alignment:
one element a thread).
``fused_curve_apply.path_launches`` counts each path's launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import launch_error, refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
UPSAMPLE_PATHS = ("general", "vec")   # the C entry's path codes 0, 1
VEC_SCALES = (2, 4, 8)
APPLY_PATHS = ("general", "vec")      # dce_curve_apply's path codes 0, 1
SPAN_ITERS = 8                        # per-iteration curves the "vec" path takes


def apply_curves(x: torch.Tensor, curves: torch.Tensor, num_iters: int,
                 shared: bool) -> torch.Tensor:
    """Iterative quadratic curve: y <- y + r_i * (y^2 - y).

    ``curves`` is (..., H, W, C*num_iters) (per-iter) or (..., H, W, C)
    (shared, Zero-DCE++).
    """
    y = x
    c = x.shape[-1]
    for i in range(num_iters):
        r = curves if shared else curves[..., i * c : (i + 1) * c]
        y = y + r * (y * y - y)
    return y


# -- plain versions ----------------------------------------------------------
# They repeat the kernels' arithmetic: the curve is read in the storage type,
# y is carried in float32 and stored once. In float32 they are exactly
# ``apply_curves`` (after ``F.interpolate`` for the upsample variant).

def fused_curve_apply_plain(image: torch.Tensor, curves: torch.Tensor,
                            num_iters: int = 8, shared: bool = False) -> torch.Tensor:
    y = apply_curves(image.float(), curves.float(), num_iters, shared)
    return y.to(image.dtype)


def fused_curve_upsample_apply_plain(image: torch.Tensor, curves_lr: torch.Tensor,
                                     num_iters: int = 8, scale: int = 4) -> torch.Tensor:
    n, h, w, c = image.shape
    r = F.interpolate(curves_lr.float().permute(0, 3, 1, 2), size=(h, w),
                      mode="bilinear", align_corners=False)
    # the kernel rounds the interpolated curve to the storage type
    r = r.to(image.dtype).float().permute(0, 2, 3, 1)
    return apply_curves(image.float(), r, num_iters, True).to(image.dtype)


# -- kernels -----------------------------------------------------------------

@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dce_curve")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.dce_curve_upsample_apply.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                             i32, i32, i32, vp]
    lib.dce_curve_upsample_apply.restype = i32
    lib.dce_curve_apply.argtypes = [vp, vp, vp, i32, i64, i32, i32, i32, i32, i32, vp]
    lib.dce_curve_apply.restype = i32
    return lib


def _check_pair(fn: str, image: torch.Tensor, curves: torch.Tensor) -> None:
    if image.ndim != 4 or curves.ndim != 4:
        raise ValueError(f"{fn}: expected NHWC tensors, got image {tuple(image.shape)}"
                         f" and curves {tuple(curves.shape)}")
    if image.dtype not in _DTYPE_CODES or curves.dtype != image.dtype:
        raise TypeError(f"{fn}: expected float32 or bfloat16 tensors of one dtype,"
                        f" got {image.dtype} and {curves.dtype}")
    if image.device != curves.device:
        raise ValueError(f"{fn}: image on {image.device}, curves on {curves.device}")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {image.device}")
    if not (image.is_contiguous() and curves.is_contiguous()):
        raise ValueError(f"{fn}: expected contiguous NHWC tensors")


def fused_curve_apply(image: torch.Tensor, curves: torch.Tensor, num_iters: int = 8,
                      shared: bool = False) -> torch.Tensor:
    """y = iterate(y + r_i*(y^2-y)) with y held in registers across iterations.

    image: (N, H, W, C); curves: (N, H, W, C*num_iters) or, with ``shared``,
    (N, H, W, C). Iteration i reads channels [i*C, (i+1)*C) of each pixel.
    """
    _check_pair("fused_curve_apply", image, curves)
    n, h, w, c = image.shape
    rc = c if shared else c * num_iters
    if tuple(curves.shape) != (n, h, w, rc):
        raise ValueError(f"fused_curve_apply: curves {tuple(curves.shape)} do not"
                         f" match image {tuple(image.shape)} with num_iters="
                         f"{num_iters}, shared={shared}")
    if image.device.type == "cpu":
        return fused_curve_apply_plain(image, curves, num_iters, shared)
    refuse_grad("fused_curve_apply", image, curves)
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    path = apply_path(image.shape, image.dtype, shared,
                      (image.data_ptr(), curves.data_ptr(), out.data_ptr()), num_iters)
    _apply_launch(image, curves, num_iters, shared, path, out)
    fused_curve_apply.launches += 1
    fused_curve_apply.path_launches[path] += 1
    return out


def apply_path(shape, dtype: torch.dtype, shared: bool, ptrs, num_iters: int) -> str:
    """The path that takes an NHWC image of ``shape`` and ``dtype`` with its
    curves (shared, or ``num_iters`` per-iteration curves) at the addresses
    ``ptrs`` (image, curves, output): ``"vec"`` where all three are 16-byte
    aligned and the curve is shared (any C) or C = 3 with ``SPAN_ITERS``
    iterations, else ``"general"``."""
    image, curves, out = ptrs
    if (dtype in _DTYPE_CODES and (image | curves | out) % 16 == 0
            and (shared or (shape[-1] == 3 and num_iters == SPAN_ITERS))):
        return "vec"
    return "general"


def _apply_launch(image: torch.Tensor, curves: torch.Tensor, num_iters: int, shared: bool,
                  path: str, out: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the apply kernel's ``path`` on checked CUDA inputs,
    into ``out`` (allocated here if not given): the wrapper's; ``chip_smoke.py``
    also times the general path on the vec path's inputs through it. Counts
    nothing."""
    out = torch.empty_like(image) if out is None else out
    c = image.shape[-1]
    rc = c if shared else c * num_iters
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = _lib().dce_curve_apply(image.data_ptr(), curves.data_ptr(), out.data_ptr(),
                                     _DTYPE_CODES[image.dtype], image.numel(), c, rc,
                                     num_iters, int(shared), APPLY_PATHS.index(path), stream)
    if err:
        raise launch_error("fused_curve_apply", err)
    return out


fused_curve_apply.launches = 0
fused_curve_apply.path_launches = dict.fromkeys(APPLY_PATHS, 0)


def upsample_path(shape, dtype: torch.dtype, scale: int, ptr: int) -> str:
    """The kernel that takes an NHWC image of ``shape`` and ``dtype`` at
    address ``ptr`` upsampled from 1/``scale``: ``"vec"`` where C = 3, the
    scale is 2, 4 or 8, W is a multiple of 8, a row is a multiple of 16
    bytes and the base is 16-byte aligned (a warp loads and stores its span
    of a row as 16-byte vectors; the output is allocated aligned), else
    ``"general"``."""
    w, c = shape[-2], shape[-1]
    size = torch.empty((), dtype=dtype).element_size()
    if (c == 3 and int(scale) in VEC_SCALES and w % 8 == 0 and w * c * size % 16 == 0
            and ptr % 16 == 0):
        return "vec"
    return "general"


def fused_curve_upsample_apply(image: torch.Tensor, curves_lr: torch.Tensor,
                               num_iters: int = 8, scale: int = 4) -> torch.Tensor:
    """Zero-DCE++ fast path: a shared curve at 1/scale resolution,
    interpolated in the kernel and applied ``num_iters`` times.

    image: (N, H, W, C); curves_lr: (N, H/scale, W/scale, C). H, W must be
    multiples of scale (the engine pads to the divisor anyway).
    """
    _check_pair("fused_curve_upsample_apply", image, curves_lr)
    n, h, w, c = image.shape
    s = int(scale)
    if h % s or w % s:
        raise ValueError(f"H, W must be multiples of scale={s}; got {h}x{w}")
    if tuple(curves_lr.shape) != (n, h // s, w // s, c):
        raise ValueError(f"fused_curve_upsample_apply: curves_lr "
                         f"{tuple(curves_lr.shape)} is not image "
                         f"{tuple(image.shape)} at 1/{s}")
    if image.device.type == "cpu":
        return fused_curve_upsample_apply_plain(image, curves_lr, num_iters, s)
    refuse_grad("fused_curve_upsample_apply", image, curves_lr)
    if n * h > _INT32_MAX or w * c > _INT32_MAX:
        raise ValueError(f"fused_curve_upsample_apply: image {tuple(image.shape)} "
                         "exceeds the kernel's 32-bit row indexing")
    path = upsample_path(image.shape, image.dtype, s, image.data_ptr())
    out = _upsample_launch(image, curves_lr, num_iters, s, path)
    fused_curve_upsample_apply.launches += 1
    fused_curve_upsample_apply.path_launches[path] += 1
    return out


def _upsample_launch(image: torch.Tensor, curves_lr: torch.Tensor, num_iters: int, s: int,
                     path: str) -> torch.Tensor:
    """One launch of the upsample kernel's ``path`` on checked CUDA inputs
    (the wrapper's; ``chip_smoke.py`` also times the general path on the
    vec path's inputs through it). Counts nothing."""
    n, h, w, c = image.shape
    out = torch.empty_like(image)
    if out.numel() == 0:
        return out
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = _lib().dce_curve_upsample_apply(
            image.data_ptr(), curves_lr.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[image.dtype], n, h, w, c, s, num_iters,
            UPSAMPLE_PATHS.index(path), stream)
    if err:
        raise launch_error("fused_curve_upsample_apply", err)
    return out


fused_curve_upsample_apply.launches = 0
fused_curve_upsample_apply.path_launches = dict.fromkeys(UPSAMPLE_PATHS, 0)
