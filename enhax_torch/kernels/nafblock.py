"""The fused NAFBlock: CUDA kernels for Hopper and their plain versions.

Port of ``enhax/kernels/nafblock.py``. Run as separate ops, a NAFBlock
makes about ten round trips through device memory, half of them at twice
the block's width. Two kernels (``csrc/nafblock.cu``) keep the chain on the
chip:

  K1 ``k1_apply``: LayerNorm -> 1x1 (C->2C) -> depthwise 3x3 -> SimpleGate.
      The 3x3 needs the 1x1's output around each pixel, so each block
      computes it over its tile plus a one-pixel halo; halo pixels outside
      the image are zero *after* the 1x1 (the dw conv's SAME padding).
  pooling: the TLC local mean (``box_mean_fast``) or the global mean of g,
      in PyTorch ops, as the JAX package leaves it to XLA.
  K2 ``k2_apply``: SCA (pooled 1x1) * g -> 1x1 -> x + .*beta -> LayerNorm
      -> 1x1 (C->2C) -> SimpleGate -> 1x1 -> x1 + .*gamma. Per pixel.

Rounding, as in the TPU kernels: matmul operands are cast to the params'
dtype and products accumulate in float32; LayerNorm, the dw taps, the gate
and the residuals are float32; the output is stored once in x's dtype. The
plain versions round at the same places (``torch.matmul`` of two bf16
tensors would round its product to bf16; they multiply in float32 instead).

Each kernel has two forms, fixed when it is compiled (``design``): the bf16
forms (the 1x1s on the tensor cores, weights bf16 in shared memory, tiles
by 16-byte ``cp.async``) for bfloat16, the general forms (float32 FMAs) for
float32. The bf16 forms take their weights in a layout prepared once per
parameter version (``k1_weights``, ``k2_weights``) and need every base
16-byte aligned; the wrapper raises otherwise.

A block's params are ``dict(block.named_parameters())`` of
``enhax_torch.models.multitask.nafnet.NAFBlock``: the reference torch names
and shapes (``conv1.weight`` (2C, C, 1, 1), ``beta`` (1, C, 1, 1), ...).
Each wrapper takes NHWC contiguous tensors. A tensor on the CPU goes to the
plain version; a CUDA tensor goes to the kernel, or the wrapper raises (it
also raises where autograd would record the call: the kernels have no
backward). Each wrapper counts its launches in ``launches``.

Training goes through ``nafblock_fused`` (``NAFBlockFused``, the JAX
package's ``custom_vjp`` of the same name): K1 -> pool -> K2 forward under
no_grad, and a backward that recomputes ``nafblock_eager`` from the saved
input and params under autograd.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import aligned16, launch_error, prepared, refuse_grad
from enhax_torch.kernels.box import box_mean_fast
from enhax_torch.nn.layers import layer_norm

LN_EPS = 1e-6
KERNEL_CHANNELS = (8, 16, 32, 64)   # the channel counts the kernels are built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_INT32_MAX = 2**31 - 1

K1_KEYS = ("norm1.weight", "norm1.bias", "conv1.weight", "conv1.bias",
           "conv2.weight", "conv2.bias")
K2_KEYS = ("sca.1.weight", "sca.1.bias", "conv3.weight", "conv3.bias", "beta",
           "norm2.weight", "norm2.bias", "conv4.weight", "conv4.bias",
           "conv5.weight", "conv5.bias", "gamma")


def _numel(key: str, c: int) -> int:
    """Elements of a block param at width c."""
    if key == "conv1.weight":
        return 2 * c * c
    if key == "conv2.weight":
        return 2 * c * 9
    if key in ("conv1.bias", "conv2.bias", "conv4.bias"):
        return 2 * c
    if key == "conv4.weight":
        return 2 * c * c
    if key in ("sca.1.weight", "conv3.weight", "conv5.weight"):
        return c * c
    return c


def simple_gate(y: torch.Tensor) -> torch.Tensor:
    a, b = y.chunk(2, dim=-1)
    return a * b


# -- plain versions ----------------------------------------------------------

def _dense(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """1x1 conv on NHWC float32 y: the operand is rounded to the weight's
    dtype, the product taken and summed in float32."""
    w = weight.reshape(weight.shape[0], -1).float()
    return y.to(weight.dtype).float() @ w.t() + bias.float()


def _ln(y: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return layer_norm(y, p[f"{name}.weight"].float(), p[f"{name}.bias"].float(), LN_EPS)


def _k1_math(xf: torch.Tensor, p: dict) -> torch.Tensor:
    """LN -> 1x1 -> dw3x3 -> gate on float32 NHWC x; float32 g."""
    y = _dense(_ln(xf, p, "norm1"), p["conv1.weight"], p["conv1.bias"])
    w = p["conv2.weight"]
    y = F.conv2d(y.permute(0, 3, 1, 2), w.float(), p["conv2.bias"].float(), padding=1,
                 groups=w.shape[0]).permute(0, 2, 3, 1)
    return simple_gate(y)


def _k2_math(xf: torch.Tensor, gf: torch.Tensor, pooled: torch.Tensor,
             p: dict) -> torch.Tensor:
    """SCA -> 1x1 -> residual -> LN -> gated FFN on float32 x, g; float32 out.
    ``pooled`` is (B, H, W, C) or (B, 1, 1, C)."""
    att = _dense(pooled.float(), p["sca.1.weight"], p["sca.1.bias"])
    y = _dense(gf * att, p["conv3.weight"], p["conv3.bias"])
    x1 = xf + y * p["beta"].float().reshape(-1)
    y = _dense(_ln(x1, p, "norm2"), p["conv4.weight"], p["conv4.bias"])
    y = _dense(simple_gate(y), p["conv5.weight"], p["conv5.bias"])
    return x1 + y * p["gamma"].float().reshape(-1)


def k1_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K1's plain version: g in x's dtype."""
    return _k1_math(x.float(), p).to(x.dtype)


def k2_plain(x: torch.Tensor, g: torch.Tensor, pooled: torch.Tensor, p: dict) -> torch.Tensor:
    """K2's plain version: the block's output in x's dtype."""
    return _k2_math(x.float(), g.float(), pooled, p).to(x.dtype)


# -- kernels -----------------------------------------------------------------

@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("nafblock")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nafblock_k1.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.nafblock_k1.restype = i32
    lib.nafblock_k2.argtypes = [vp, vp, vp, i32, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.nafblock_k2.restype = i32
    return lib


def design(c: int, dtype: torch.dtype) -> dict:
    """Which form K1 and K2 take at width ``c`` for ``dtype``: "bf16" (the
    1x1s on mma.sync with bf16 operands, weights bf16 in shared memory; K1
    walks strips of 62 columns, 30 at C = 64, down the rows through a ring
    of projected rows, K2's warps own 16 pixels through the chain) or
    "general" (float32 FMAs: the float32 path; a tensor-core product of
    float32 operands would be TF32). The library dispatches on dtype alone:
    bfloat16 takes the bf16 forms at every width (C = 8 pads the products'
    K to 16 with zeros)."""
    if c not in KERNEL_CHANNELS or dtype not in _DTYPE_CODES:
        raise ValueError(f"the NAFBlock kernels are built for C in {KERNEL_CHANNELS} and "
                         f"{tuple(_DTYPE_CODES)}, got C={c}, {dtype}")
    form = "bf16" if dtype == torch.bfloat16 else "general"
    return {"k1": form, "k2": form}


def _vec(*tensors: torch.Tensor) -> torch.Tensor:
    """Params flattened into one contiguous float32 array (exact for bf16)."""
    return torch.cat([t.detach().float().reshape(-1) for t in tensors]).contiguous()


def k1_weights(p: dict) -> tuple:
    """K1's params in the bf16 form's layout, prepared once per parameter
    version (``prepared``): conv1's weight (2C, C) as it is, and one float32
    array of norm1's weight and bias, conv1's and conv2's biases and conv2's
    taps transposed to (9, 2C)."""
    keys = ("conv1.weight", "norm1.weight", "norm1.bias", "conv1.bias", "conv2.bias",
            "conv2.weight")

    def make(w1, lnw, lnb, b1, dwb, dw):
        c = lnw.numel()
        taps = dw.detach().float().reshape(2 * c, 9).t()
        return w1.detach().reshape(2 * c, c).contiguous(), _vec(lnw, lnb, b1, dwb, taps)

    return prepared("k1 bf16", tuple(p[k] for k in keys), make)


def k2_weights(p: dict) -> tuple:
    """K2's params in the bf16 form's layout, prepared once per parameter
    version: the weights of sca.1, conv3, conv4 and conv5 as (O, C)
    matrices, and one float32 array of sca.1's and conv3's biases, beta,
    norm2's weight and bias, conv4's and conv5's biases and gamma."""
    keys = ("sca.1.weight", "conv3.weight", "conv4.weight", "conv5.weight", "sca.1.bias",
            "conv3.bias", "beta", "norm2.weight", "norm2.bias", "conv4.bias", "conv5.bias",
            "gamma")

    def make(wsca, w3, w4, w5, *vectors):
        mats = tuple(w.detach().reshape(w.shape[0], -1).contiguous() for w in (wsca, w3, w4, w5))
        return (*mats, _vec(*vectors))

    return prepared("k2 bf16", tuple(p[k] for k in keys), make)


def _check(fn: str, x: torch.Tensor, acts: dict, p: dict, keys: tuple) -> None:
    """Shapes and devices for both branches; dtypes, contiguity and widths
    the kernel takes for a CUDA tensor."""
    if x.ndim != 4:
        raise ValueError(f"{fn}: expected NHWC x, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    missing = [k for k in keys if k not in p]
    if missing:
        raise KeyError(f"{fn}: params lack {missing}")
    tensors = {**acts, **{k: p[k] for k in keys}}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{fn}: x on {x.device}, {name} on {t.device}")
    for k in keys:
        if p[k].numel() != _numel(k, c):
            raise ValueError(f"{fn}: {k} has shape {tuple(p[k].shape)}, which does "
                             f"not fit C={c}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"{fn}: the kernel is built for C in {KERNEL_CHANNELS}, got {c}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn}: expected float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{fn}: the kernel takes one dtype; x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    b, h, w, _ = x.shape
    if b > _MAX_GRID_YZ or h * w > _INT32_MAX:
        raise ValueError(f"{fn}: x {tuple(x.shape)} exceeds the kernel's grid")


def _pointers(tensors) -> ctypes.Array:
    tensors = tuple(tensors)
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def k1_apply(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K1: g = SimpleGate(dw3x3(LN(x) @ W1 + b1) + b2), (B, H, W, C)."""
    _check("k1_apply", x, {}, p, K1_KEYS)
    if x.device.type == "cpu":
        return k1_plain(x, p)
    refuse_grad("k1_apply", x, *(p[k] for k in K1_KEYS))
    g = torch.empty_like(x)
    if g.numel() == 0:
        return g
    b, h, w, c = x.shape
    if design(c, x.dtype)["k1"] == "bf16":
        prm = k1_weights(p)
        aligned16("k1_apply", {"x": x, **{f"prepared param {i}": t for i, t in enumerate(prm)}})
    else:
        prm = tuple(p[k] for k in K1_KEYS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().nafblock_k1(x.data_ptr(), _pointers(prm), g.data_ptr(),
                                 _DTYPE_CODES[x.dtype], b, h, w, c, stream)
    if err:
        raise launch_error("k1_apply", err)
    k1_apply.launches += 1
    return g


k1_apply.launches = 0


def k2_apply(x: torch.Tensor, g: torch.Tensor, pooled: torch.Tensor, p: dict) -> torch.Tensor:
    """K2: SCA apply -> 1x1 -> residual -> LN -> gated FFN -> residual.

    ``pooled`` is the TLC local mean of g, (B, H, W, C), or its global
    mean, (B, 1, 1, C).
    """
    _check("k2_apply", x, {"g": g, "pooled": pooled}, p, K2_KEYS)
    b, h, w, c = x.shape
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"k2_apply: g {tuple(g.shape)} is not x's shape {tuple(x.shape)}")
    spatial = tuple(pooled.shape) == tuple(x.shape)
    if not spatial and tuple(pooled.shape) != (b, 1, 1, c):
        raise ValueError(f"k2_apply: pooled {tuple(pooled.shape)} is neither "
                         f"{tuple(x.shape)} nor {(b, 1, 1, c)}")
    if x.device.type == "cpu":
        return k2_plain(x, g, pooled, p)
    refuse_grad("k2_apply", x, g, pooled, *(p[k] for k in K2_KEYS))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if design(c, x.dtype)["k2"] == "bf16":
        prm = k2_weights(p)
        aligned16("k2_apply", {"x": x, "g": g, "pooled": pooled, "out": out,
                               **{f"prepared param {i}": t for i, t in enumerate(prm)}})
    else:
        prm = tuple(p[k] for k in K2_KEYS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().nafblock_k2(x.data_ptr(), g.data_ptr(), pooled.data_ptr(), int(spatial),
                                 _pointers(prm), out.data_ptr(),
                                 _DTYPE_CODES[x.dtype], b, h, w, c, stream)
    if err:
        raise launch_error("k2_apply", err)
    k2_apply.launches += 1
    return out


k2_apply.launches = 0


# -- the block and the network -----------------------------------------------

def nafblock_fast(x: torch.Tensor, p: dict, tlc_window: int | None) -> torch.Tensor:
    """One NAFBlock through the fused kernels: K1, the TLC local mean of g
    (or its global mean), K2."""
    g = k1_apply(x, p)
    if tlc_window is None:
        pooled = g.mean(dim=(1, 2), keepdim=True)
    else:
        pooled = box_mean_fast(g, tlc_window // 2)
    return k2_apply(x, g, pooled, p)


def nafblock_eager(x: torch.Tensor, p: dict, tlc_window: int | None) -> torch.Tensor:
    """One NAFBlock in plain PyTorch ops, with the fused path's rounding.

    The counterpart of ``nafblock_xla`` in ``enhax/kernels/nafblock.py``:
    the JAX package's own non-Pallas path, which ``nafnet_fast_apply`` takes
    above ``fused_max_c``. Unlike K1 -> K2, g stays float32 between the
    halves, and the pooling runs on it in float32.
    """
    xf = x.float()
    g = _k1_math(xf, p)
    if tlc_window is None:
        pooled = g.mean(dim=(1, 2), keepdim=True)
    else:
        pooled = box_mean_fast(g, tlc_window // 2)
    return _k2_math(xf, g, pooled, p).to(x.dtype)


PARAM_KEYS = K1_KEYS + K2_KEYS   # the order NAFBlockFused takes a block's params in


class NAFBlockFused(torch.autograd.Function):
    """A NAFBlock whose forward runs ``nafblock_fast`` (K1 -> pool -> K2 on
    the card; their plain versions on the CPU) and whose backward is the VJP
    of ``nafblock_eager``, recomputed from the saved input and params.

    The counterpart of ``nafblock_fused`` in ``enhax/kernels/nafblock.py``
    (a ``jax.custom_vjp``: Pallas forward, the VJP of ``nafblock_xla`` by
    recompute). ``forward(ctx, x, tlc_window, *params)`` takes the block's
    params in ``PARAM_KEYS`` order; the gradients come back in the dtypes of
    x and the params (the block math runs in float32 inside).
    """

    @staticmethod
    def forward(ctx, x, tlc_window, *params):
        ctx.tlc_window = tlc_window
        ctx.save_for_backward(x, *params)
        with torch.no_grad():
            return nafblock_fast(x, dict(zip(PARAM_KEYS, params)), tlc_window)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:1] + ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad(), torch.profiler.record_function("nafblock_fused.recompute"):
            out = nafblock_eager(inputs[0], dict(zip(PARAM_KEYS, inputs[1:])), ctx.tlc_window)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
        got = [next(grads) if t.requires_grad else None for t in inputs]
        return (got[0], None, *got[1:])


def nafblock_fused(x: torch.Tensor, p: dict, tlc_window: int | None = None) -> torch.Tensor:
    """One differentiable NAFBlock through the fused kernels (``NAFBlockFused``)."""
    return NAFBlockFused.apply(x, tlc_window, *(p[k] for k in PARAM_KEYS))


def nafnet_fast_apply(net, x: torch.Tensor, fused_max_c: int = 64,
                      training: bool = False) -> dict:
    """NAFNet forward with fused NAFBlocks where C <= ``fused_max_c`` and
    ``nafblock_eager`` above it; the intro, down, up and ending convs are the
    module's own. ``net`` is a ``NAFNetModule``; x is NHWC.

    For inference the fused blocks are ``nafblock_fast`` (the kernels refuse
    autograd: call under ``torch.inference_mode()``). With ``training=True``
    they are ``nafblock_fused``, differentiable, and the blocks above
    ``fused_max_c`` run ``nafblock_eager`` under autograd, as the JAX
    package's ``nafblock_xla``."""
    tlc = net.tlc_window
    fused_block = nafblock_fused if training else nafblock_fast

    def blocks(y, seq):
        for blk in seq:
            p = dict(blk.named_parameters())
            y = y.contiguous()
            if y.shape[-1] <= fused_max_c:
                y = fused_block(y, p, tlc)
            else:
                y = nafblock_eager(y, p, tlc)
        return y

    y = net.intro(x)
    skips = []
    for enc, down in zip(net.encoders, net.downs):
        y = blocks(y, enc)
        skips.append(y)
        y = down(y)
    y = blocks(y, net.middle_blks)
    for up, dec, skip in zip(net.ups, net.decoders, reversed(skips)):
        y = up(y) + skip
        y = blocks(y, dec)
    return {"enhanced": net.ending(y) + x}
