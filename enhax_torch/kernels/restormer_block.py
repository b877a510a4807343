"""The fused RestormerBlock: CUDA kernels for Hopper and their plain versions.

Port of ``enhax/kernels/restormer_block.py``. A RestormerBlock run as
separate ops touches its (B, H, W, C..5.3C) activations some 60 channel
widths a block; two kernels (``csrc/restormer_block.cu``) and a C x C glue
keep the chain on the chip:

  R1 ``r1_apply``: LN1 -> qkv 1x1 (C->3C) -> depthwise 3x3. Only V leaves
      the kernel; q and k are consumed by the per-head raw gram q^T k and
      the per-channel sums of squares, summed over every pixel of the image.
      MDTA's pixel-axis l2 norm factors out of the gram:
      (q/|q_c|)^T (k/|k_d|) = (q^T k)[c, d] / (|q_c| |k_d|).
  glue ``mdta_attention``: gram / norms * temperature -> softmax, in
      PyTorch ops (C x C-sized; the JAX package leaves it to XLA).
  R2 ``r2_apply``: attn @ v -> project_out -> +x -> LN2 -> project_in
      (C->2h) -> depthwise 3x3 -> gelu(a) * b -> project_out (h->C) -> +x1.

Rounding, as in the TPU kernels: matmul operands (LN outputs, q and k for
the gram, attn and v, the attention output, the gate) are cast to the
params' dtype and products summed in float32; LayerNorm, the dw taps, GELU
and the residuals are float32; outputs are stored once in x's dtype. The
sums of squares are of the unrounded float32 q and k. The plain versions
round at the same places and multiply in float32.

A block's params are ``dict(block.named_parameters())`` of
``enhax_torch.models.multitask.restormer.RestormerBlock``: the reference
torch names and shapes (``attn.qkv.weight`` (3C, C, 1, 1), ``attn.temperature``
(heads, 1, 1), ...). Tensors are NHWC and contiguous. A tensor on the CPU
goes to the plain version; a CUDA tensor goes to the kernel, or the wrapper
raises (also where autograd would record the call). Each wrapper counts its
launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import launch_error, refuse_grad
from enhax_torch.nn.layers import gelu_erf, layer_norm

LN_EPS = 1e-5
# the (C, heads) pairs of Restormer's levels, which the kernels are built for
KERNEL_WIDTHS = ((48, 1), (96, 1), (96, 2), (192, 4), (384, 8))
HIDDEN_CHUNK = 32   # R2 walks the GDFN's hidden channels in chunks of 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_INT32_MAX = 2**31 - 1

R1_KEYS = ("norm1.body.weight", "norm1.body.bias", "attn.temperature",
           "attn.qkv.weight", "attn.qkv_dwconv.weight")
R2_KEYS = ("attn.project_out.weight", "norm2.body.weight", "norm2.body.bias",
           "ffn.project_in.weight", "ffn.dwconv.weight", "ffn.project_out.weight")


def _shapes(c: int, heads: int, hidden: int) -> dict:
    """The shape each block param has at width c."""
    return {"norm1.body.weight": (c,), "norm1.body.bias": (c,),
            "attn.temperature": (heads, 1, 1), "attn.qkv.weight": (3 * c, c, 1, 1),
            "attn.qkv_dwconv.weight": (3 * c, 1, 3, 3),
            "attn.project_out.weight": (c, c, 1, 1),
            "norm2.body.weight": (c,), "norm2.body.bias": (c,),
            "ffn.project_in.weight": (2 * hidden, c, 1, 1),
            "ffn.dwconv.weight": (2 * hidden, 1, 3, 3),
            "ffn.project_out.weight": (c, hidden, 1, 1)}


# -- plain versions ----------------------------------------------------------

def _dense(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Bias-free 1x1 conv on NHWC float32 y: the operand is rounded to the
    weight's dtype, the product taken and summed in float32."""
    w = weight.reshape(weight.shape[0], -1).float()
    return y.to(weight.dtype).float() @ w.t()


def _dw3x3(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Bias-free depthwise 3x3, SAME zero padding, float32."""
    out = F.conv2d(y.permute(0, 3, 1, 2), weight.float(), padding=1, groups=weight.shape[0])
    return out.permute(0, 2, 3, 1)


def r1_plain(x: torch.Tensor, p: dict):
    """R1's plain version: (v in x's dtype, gram (B, heads*hd, hd), qss and
    kss (B, 1, C)), the last three float32 (summed in float64)."""
    b, h, w, c = x.shape
    heads = p["attn.temperature"].shape[0]
    hd = c // heads
    y = layer_norm(x.float(), p["norm1.body.weight"].float(), p["norm1.body.bias"].float(),
                   LN_EPS)
    qkv = _dw3x3(_dense(y, p["attn.qkv.weight"]), p["attn.qkv_dwconv.weight"])
    q, k, v = qkv.split(c, dim=-1)
    # the sums over every pixel run in float64 and are rounded once: a
    # float32 sum over ~150k pixels carries an error near 1e-5 of its value
    qss = q.double().square().sum(dim=(1, 2)).float().reshape(b, 1, c)
    kss = k.double().square().sum(dim=(1, 2)).float().reshape(b, 1, c)
    dt = p["attn.qkv.weight"].dtype
    qr = q.to(dt).double().reshape(b, h * w, heads, hd)
    kr = k.to(dt).double().reshape(b, h * w, heads, hd)
    gram = torch.einsum("bphc,bphd->bhcd", qr, kr).float().reshape(b, heads * hd, hd)
    return v.to(x.dtype).contiguous(), gram, qss, kss


def mdta_attention(gram: torch.Tensor, qss: torch.Tensor, kss: torch.Tensor,
                   temperature: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The glue between R1 and R2: logits = gram / (max(|q_c|, 1e-6)
    max(|k_d|, 1e-6)) * temperature, softmax over d; (B, heads*hd, hd),
    float32 or cast to ``dtype``."""
    b, rows, hd = gram.shape
    heads = rows // hd
    g = gram.reshape(b, heads, hd, hd)
    qn = qss.sqrt().reshape(b, heads, hd, 1).clamp_min(1e-6)
    kn = kss.sqrt().reshape(b, heads, 1, hd).clamp_min(1e-6)
    temp = temperature.float().reshape(1, heads, 1, 1)
    attn = (g / (qn * kn) * temp).softmax(dim=-1).reshape(b, rows, hd)
    return attn if dtype is None else attn.to(dtype)


def r2_plain(x: torch.Tensor, v: torch.Tensor, attn: torch.Tensor, p: dict) -> torch.Tensor:
    """R2's plain version: the block's output in x's dtype."""
    b, h, w, c = x.shape
    hd = attn.shape[-1]
    heads = c // hd
    a = attn.float().reshape(b, heads, hd, hd)
    vr = v.float().reshape(b, h * w, heads, hd)
    att_out = torch.einsum("bhcd,bphd->bphc", a, vr).reshape(b, h, w, c)
    x1 = x.float() + _dense(att_out, p["attn.project_out.weight"])
    y = layer_norm(x1, p["norm2.body.weight"].float(), p["norm2.body.bias"].float(), LN_EPS)
    ga, gb = _dw3x3(_dense(y, p["ffn.project_in.weight"]), p["ffn.dwconv.weight"]).chunk(2, -1)
    out = x1 + _dense(gelu_erf(ga) * gb, p["ffn.project_out.weight"])
    return out.to(x.dtype)


# -- kernels -----------------------------------------------------------------

@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("restormer_block")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.restormer_r1_splits.argtypes = [i32, i32, i32, i32, i32, i32]
    lib.restormer_r1_splits.restype = i32
    lib.restormer_r1.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                 i32, i32, vp]
    lib.restormer_r1.restype = i32
    lib.restormer_r2.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.restormer_r2.restype = i32
    return lib


def _check(fn: str, x: torch.Tensor, acts: dict, p: dict, keys: tuple) -> tuple[int, int]:
    """Shapes and devices for both branches; dtypes, contiguity and widths
    the kernel takes for a CUDA tensor. Returns (heads, hidden)."""
    if x.ndim != 4:
        raise ValueError(f"{fn}: expected NHWC x, got shape {tuple(x.shape)}")
    missing = [k for k in keys if k not in p]
    if missing:
        raise KeyError(f"{fn}: params lack {missing}")
    c = x.shape[-1]
    # R2 reads the heads off attn (B, C, hd), R1 off the temperature
    heads = c // acts["attn"].shape[-1] if "attn" in acts else p["attn.temperature"].shape[0]
    hidden = p["ffn.project_out.weight"].shape[1] if "ffn.project_out.weight" in p else 0
    want = _shapes(c, heads, hidden)
    for k in keys:
        if tuple(p[k].shape) != want[k]:
            raise ValueError(f"{fn}: {k} has shape {tuple(p[k].shape)}, which does not fit "
                             f"C={c}, heads={heads}")
    tensors = {**acts, **{k: p[k] for k in keys}}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{fn}: x on {x.device}, {name} on {t.device}")
    if x.device.type == "cpu":
        return heads, hidden
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if (c, heads) not in KERNEL_WIDTHS:
        raise ValueError(f"{fn}: the kernel is built for (C, heads) in {KERNEL_WIDTHS}, "
                         f"got ({c}, {heads})")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn}: expected float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{fn}: the kernel takes one dtype; x is {x.dtype}, "
                            f"{name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    b, h, w, _ = x.shape
    if b > _MAX_GRID_YZ or h * w * c > _INT32_MAX:
        raise ValueError(f"{fn}: x {tuple(x.shape)} exceeds the kernel's grid")
    return heads, hidden


def _f32(t: torch.Tensor, rows: int) -> torch.Tensor:
    """A param as a contiguous float32 (rows, -1) matrix (exact for bf16)."""
    return t.detach().float().reshape(rows, -1).contiguous()


def _gdfn_weights(p: dict, c: int, hidden: int):
    """project_in, its dw taps and project_out for R2, hidden padded to a
    multiple of ``HIDDEN_CHUNK`` with zero weights and taps (exact:
    gelu(0) * 0 = 0), and the rows of project_in and of the taps reordered
    so that each chunk's gate pairs (a_j, b_j) are adjacent: rows
    [a chunk 0, b chunk 0, a chunk 1, b chunk 1, ...]."""
    hp = -(-hidden // HIDDEN_CHUNK) * HIDDEN_CHUNK
    nch = hp // HIDDEN_CHUNK

    def halves(t, cols):
        t = _f32(t, 2 * hidden)
        out = t.new_zeros(2, hp, cols)
        out[0, :hidden], out[1, :hidden] = t[:hidden], t[hidden:]
        out = out.reshape(2, nch, HIDDEN_CHUNK, cols).transpose(0, 1)
        return out.reshape(2 * hp, cols).contiguous()

    w_out = _f32(p["ffn.project_out.weight"], c)
    w_out = F.pad(w_out, (0, hp - hidden)).contiguous()
    return halves(p["ffn.project_in.weight"], c), halves(p["ffn.dwconv.weight"], 9), w_out, hp


@lru_cache(maxsize=None)
def _r1_splits(code: int, c: int, heads: int, b: int, h: int, w: int) -> int:
    s = _lib().restormer_r1_splits(code, c, heads, b, h, w)
    if s <= 0:
        raise launch_error("r1_apply", -s)
    return s


def r1_apply(x: torch.Tensor, p: dict):
    """R1: (v, gram, qss, kss) of one RestormerBlock's MDTA, as ``r1_plain``.

    Each block of the kernel walks a run of tiles of one image and one head
    and writes its partial gram and sums; a second kernel sums the partials
    in a fixed order, so the result is the same from run to run."""
    heads, _ = _check("r1_apply", x, {}, p, R1_KEYS)
    if x.device.type == "cpu":
        return r1_plain(x, p)
    refuse_grad("r1_apply", x, *(p[k] for k in R1_KEYS))
    b, h, w, c = x.shape
    hd = c // heads
    v = torch.empty_like(x)
    f32 = dict(device=x.device, dtype=torch.float32)
    gram = torch.empty(b, heads * hd, hd, **f32)
    qss, kss = torch.empty(b, 1, c, **f32), torch.empty(b, 1, c, **f32)
    if x.numel() == 0:
        return v, gram.zero_(), qss.zero_(), kss.zero_()
    code = _DTYPE_CODES[x.dtype]
    splits = _r1_splits(code, c, heads, b, h, w)
    gram_part = torch.empty(b, splits, heads * hd, hd, **f32)
    ss_part = torch.empty(b, splits, 2, c, **f32)
    prm = (_f32(p["norm1.body.weight"], 1), _f32(p["norm1.body.bias"], 1),
           _f32(p["attn.qkv.weight"], 3 * c), _f32(p["attn.qkv_dwconv.weight"], 3 * c))
    ptrs = (ctypes.c_void_p * len(prm))(*(t.data_ptr() for t in prm))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().restormer_r1(x.data_ptr(), ptrs, v.data_ptr(), gram_part.data_ptr(),
                                  ss_part.data_ptr(), gram.data_ptr(), qss.data_ptr(),
                                  kss.data_ptr(), code, b, h, w, c, heads, splits, stream)
    if err:
        raise launch_error("r1_apply", err)
    r1_apply.launches += 1
    return v, gram, qss, kss


r1_apply.launches = 0


def r2_apply(x: torch.Tensor, v: torch.Tensor, attn: torch.Tensor, p: dict) -> torch.Tensor:
    """R2: attn @ v -> project_out -> +x -> LN2 -> GDFN -> +residual.

    ``attn`` is the glue's (B, heads*hd, hd) in x's dtype."""
    b, h, w, c = x.shape if x.ndim == 4 else (0, 0, 0, 0)
    if tuple(v.shape) != tuple(x.shape):
        raise ValueError(f"r2_apply: v {tuple(v.shape)} is not x's shape {tuple(x.shape)}")
    if attn.ndim != 3 or attn.shape[0] != b or attn.shape[1] != c or c % attn.shape[2]:
        raise ValueError(f"r2_apply: attn {tuple(attn.shape)} does not fit x {tuple(x.shape)}")
    heads, hidden = _check("r2_apply", x, {"v": v, "attn": attn}, p, R2_KEYS)
    if x.device.type == "cpu":
        return r2_plain(x, v, attn, p)
    refuse_grad("r2_apply", x, v, attn, *(p[k] for k in R2_KEYS))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    w_in, dw, w_out, hp = _gdfn_weights(p, c, hidden)
    prm = (attn.float().contiguous(), _f32(p["attn.project_out.weight"], c),
           _f32(p["norm2.body.weight"], 1), _f32(p["norm2.body.bias"], 1), w_in, dw, w_out)
    ptrs = (ctypes.c_void_p * len(prm))(*(t.data_ptr() for t in prm))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().restormer_r2(x.data_ptr(), v.data_ptr(), ptrs, out.data_ptr(),
                                  _DTYPE_CODES[x.dtype], b, h, w, c, heads, hp, stream)
    if err:
        raise launch_error("r2_apply", err)
    r2_apply.launches += 1
    return out


r2_apply.launches = 0


# -- the block and the network -----------------------------------------------

def restormer_block_fast(x: torch.Tensor, p: dict) -> torch.Tensor:
    """One RestormerBlock through the fused kernels: R1 -> glue -> R2."""
    v, gram, qss, kss = r1_apply(x, p)
    attn = mdta_attention(gram, qss, kss, p["attn.temperature"], x.dtype)
    return r2_apply(x, v, attn, p)


def restormer_fast_apply(net, x: torch.Tensor, fused_min_hw: int = 32) -> dict:
    """Restormer forward with fused blocks where min(H, W) >= ``fused_min_hw``
    and the module's own block below it (as the JAX package runs the flax
    block there); the resampling and reduce convs are the module's own.
    ``net`` is a ``RestormerModule``; x is NHWC."""

    def block(y, blk):
        if min(y.shape[1], y.shape[2]) >= fused_min_hw:
            return restormer_block_fast(y.contiguous(), dict(blk.named_parameters()))
        return blk(y)

    return net(x, block=block)
