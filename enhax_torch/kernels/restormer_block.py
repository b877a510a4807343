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

``restormer_block_fast(x, p, dw_mxu=True)`` runs the JAX package's
``dw_mxu`` form instead: each dw 3x3 is folded into its bias-free producing
1x1 (``fold_dw_into_pointwise``: one (9C, N) weight, rounded to the params'
dtype after the fold) and applied to the nine shifted views of the 1x1's
input (``dw9_inputs``), one product with K = 9C. ``r1_mxu_apply`` and
``r2_mxu_apply`` are its kernels; the LN output is zeroed outside the image
before the product (SAME padding of the dw conv, exact because the 1x1 has
no bias). Their weights are folded once per parameter version
(``r1_mxu_weights``, ``r2_mxu_weights``).

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
launches in ``launches``: ``r1_apply``, ``r2_apply``, ``r1_mxu_apply`` and
``r2_mxu_apply`` each their own.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from enhax_torch.kernels import _build
from enhax_torch.kernels._launch import aligned16, launch_error, prepared, refuse_grad
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
    y = layer_norm(x.float(), p["norm1.body.weight"].float(), p["norm1.body.bias"].float(),
                   LN_EPS)
    qkv = _dw3x3(_dense(y, p["attn.qkv.weight"]), p["attn.qkv_dwconv.weight"])
    return _r1_outputs(x, qkv, p)


def _r1_outputs(x, qkv, p):
    """(v, gram, qss, kss) from the float32 qkv: the sums over every pixel
    run in float64 and are rounded once (a float32 sum over ~150k pixels
    carries an error near 1e-5 of its value); the gram's operands are
    rounded to the params' dtype."""
    b, h, w, c = x.shape
    heads = p["attn.temperature"].shape[0]
    hd = c // heads
    dt = p["attn.qkv.weight"].dtype
    q, k, v = qkv.split(c, dim=-1)
    qss = q.double().square().sum(dim=(1, 2)).float().reshape(b, 1, c)
    kss = k.double().square().sum(dim=(1, 2)).float().reshape(b, 1, c)
    qr = q.to(dt).double().reshape(b, h * w, heads, hd)
    kr = k.to(dt).double().reshape(b, h * w, heads, hd)
    gram = torch.einsum("bphc,bphd->bhcd", qr, kr).float().reshape(b, heads * hd, hd)
    return v.to(x.dtype).contiguous(), gram, qss, kss


def dw9_inputs(t: torch.Tensor) -> torch.Tensor:
    """The nine tap views of a 1x1's input, for the folded (1x1 -> dw3x3).

    ``t`` (..., H+2, W, C), one halo row above and below; W is zero-padded.
    Returns (..., H, W, 9C), channel blocks in (dh, dx)-major order, as
    ``fold_dw_into_pointwise`` lays out its rows (the JAX ``_dw9_inputs``)."""
    h, w = t.shape[-3] - 2, t.shape[-2]
    planes = F.pad(t, (0, 0, 1, 1))   # W zero-padded: columns w-1, w, w+1
    return torch.cat([planes[..., dh:dh + h, dx:dx + w, :]
                      for dh in range(3) for dx in range(3)], dim=-1)


def fold_dw_into_pointwise(w_pt: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """(c_in, c_out) pointwise and (3, 3, c_out) dw taps -> (9 c_in, c_out):
    row (3 dh + dx) c_in + i holds W[i, o] k[dh, dx, o] (the JAX
    ``_fold_dw_into_pointwise``), so that for a bias-free W
    dw3x3(t @ W) = dw9_inputs(t) @ fold(W, k) exactly."""
    c_in, c_out = w_pt.shape
    return (w_pt[None, None] * dwk[:, :, None, :]).reshape(9 * c_in, c_out)


def _folded(p: dict, wkey: str, dkey: str) -> torch.Tensor:
    """A block's 1x1 and its dw taps folded in float32 from the params, then
    rounded to the params' dtype (as the JAX package folds at
    ``restormer_block.py:324-326``): (9C, N)."""
    w = p[wkey]
    n = w.shape[0]
    w_pt = w.float().reshape(n, -1).t()
    dwk = p[dkey].float().reshape(n, 3, 3).permute(1, 2, 0)
    return fold_dw_into_pointwise(w_pt, dwk).to(w.dtype)


def _folded_conv(y: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """1x1 -> dw3x3 with SAME zero padding through the folded weight: y
    (B, H, W, C) float32 is rounded to the weight's dtype, the product
    summed in float32."""
    t = F.pad(y.to(wf.dtype).float(), (0, 0, 0, 0, 1, 1))   # zero rows above and below
    return dw9_inputs(t) @ wf.float()


def r1_mxu_plain(x: torch.Tensor, p: dict):
    """R1 with the taps folded into the qkv 1x1 (``dw_mxu``): as ``r1_plain``,
    the qkv through ``fold_dw_into_pointwise``/``dw9_inputs``."""
    y = layer_norm(x.float(), p["norm1.body.weight"].float(), p["norm1.body.bias"].float(),
                   LN_EPS)
    qkv = _folded_conv(y, _folded(p, "attn.qkv.weight", "attn.qkv_dwconv.weight"))
    return _r1_outputs(x, qkv, p)


def r1_mxu_witness_gram(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``r1_mxu_plain``'s gram with the LayerNorm and the folded product in
    float64, each rounded only where the path stores it (the LayerNorm
    through float32 to the params' dtype, the product's operand; q and k
    through float32 to the gram's operand dtype). The witness that R1-mxu's
    kernel and its plain version are held against: nearer to exact than
    either's float32 arithmetic."""
    w, b = p["norm1.body.weight"].double(), p["norm1.body.bias"].double()
    y = layer_norm(x.double(), w, b, LN_EPS)
    wf = _folded(p, "attn.qkv.weight", "attn.qkv_dwconv.weight")
    t = F.pad(y.float().to(wf.dtype).double(), (0, 0, 0, 0, 1, 1))
    return _r1_outputs(x, (dw9_inputs(t) @ wf.double()).float(), p)[1]


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
    x1, y = _r2_head(x, v, attn, p)
    gate = _dw3x3(_dense(y, p["ffn.project_in.weight"]), p["ffn.dwconv.weight"])
    return _r2_tail(x, x1, gate, p)


def r2_mxu_plain(x: torch.Tensor, v: torch.Tensor, attn: torch.Tensor, p: dict) -> torch.Tensor:
    """R2 with project_in's taps folded in (``dw_mxu``): as ``r2_plain``, the
    GDFN's 1x1 -> dw3x3 through ``fold_dw_into_pointwise``/``dw9_inputs``."""
    x1, y = _r2_head(x, v, attn, p)
    gate = _folded_conv(y, _folded(p, "ffn.project_in.weight", "ffn.dwconv.weight"))
    return _r2_tail(x, x1, gate, p)


def _r2_head(x, v, attn, p):
    """x1 = x + project_out(attn @ v) and its LayerNorm, float32."""
    b, h, w, c = x.shape
    hd = attn.shape[-1]
    heads = c // hd
    a = attn.float().reshape(b, heads, hd, hd)
    vr = v.float().reshape(b, h * w, heads, hd)
    att_out = torch.einsum("bhcd,bphd->bphc", a, vr).reshape(b, h, w, c)
    x1 = x.float() + _dense(att_out, p["attn.project_out.weight"])
    return x1, layer_norm(x1, p["norm2.body.weight"].float(), p["norm2.body.bias"].float(),
                          LN_EPS)


def _r2_tail(x, x1, gate, p):
    """x1 + project_out(gelu(a) * b) for the GDFN's (a, b) = ``gate``, in x's dtype."""
    ga, gb = gate.chunk(2, -1)
    return (x1 + _dense(gelu_erf(ga) * gb, p["ffn.project_out.weight"])).to(x.dtype)


# -- kernels -----------------------------------------------------------------

@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("restormer_block")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.restormer_r1_geometry.argtypes = [i32, i32, i32, i32, vp]
    lib.restormer_r1_geometry.restype = i32
    lib.restormer_forms.argtypes = [i32, i32, i32, i32]
    lib.restormer_forms.restype = i32
    for fn in (lib.restormer_r1, lib.restormer_r1_mxu):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
    for fn in (lib.restormer_r2, lib.restormer_r2_mxu):
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
        fn.restype = i32
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


def _rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """A param as a contiguous (rows, -1) matrix in its own dtype."""
    return t.detach().reshape(rows, -1).contiguous()


def _chunk_order(t: torch.Tensor, hidden: int, hp: int) -> torch.Tensor:
    """The GDFN's (2 hidden, cols) rows as R2 walks them: each gate half
    padded to ``hp`` with zero rows and the rows reordered so that each
    chunk's gate pairs (a_j, b_j) are adjacent: [a chunk 0, b chunk 0,
    a chunk 1, b chunk 1, ...]."""
    cols = t.shape[1]
    out = t.new_zeros(2, hp, cols)
    out[0, :hidden], out[1, :hidden] = t[:hidden], t[hidden:]
    out = out.reshape(2, hp // HIDDEN_CHUNK, HIDDEN_CHUNK, cols).transpose(0, 1)
    return out.reshape(2 * hp, cols).contiguous()


def hidden_padded(hidden: int) -> int:
    """The GDFN's hidden width padded to a multiple of ``HIDDEN_CHUNK``."""
    return -(-hidden // HIDDEN_CHUNK) * HIDDEN_CHUNK


def _gdfn_weights(w_in: torch.Tensor, w_out: torch.Tensor, hidden: int):
    """R2's GDFN weights: ``w_in`` (2 hidden, cols) (project_in or its
    tap-folded form) in ``_chunk_order`` and ``w_out`` (C, hidden) padded to
    (C, hp), the hidden width padded to hp, a multiple of ``HIDDEN_CHUNK``,
    with zero weights (exact: gelu(0) * 0 = 0); each keeps its dtype."""
    hp = hidden_padded(hidden)
    return _chunk_order(w_in, hidden, hp), F.pad(w_out, (0, hp - hidden)).contiguous()


@lru_cache(maxsize=None)
def _forms(code: int, c: int, heads: int, mxu: bool = False) -> int:
    forms = _lib().restormer_forms(code, c, heads, int(mxu))
    if forms < 0:
        raise launch_error("restormer_forms", -forms)
    return forms


def design(code: int, c: int, heads: int, mxu: bool = False) -> dict:
    """Which form R1 and R2 (``mxu``: R1-mxu and R2-mxu) take for dtype
    ``code`` at (C, heads): "bf16" (bf16 operands and weights in shared
    memory, ldmatrix, 16 warps, tiles of up to 8x16; the folded weights
    streamed through a ring of K-slices) or "general" (float32 operands in
    shared memory, 8x8 tiles, 8 warps: the float32 path). Fixed when the
    kernels are compiled."""
    forms = _forms(code, c, heads, mxu)
    return {"r1": "bf16" if forms & 1 else "general", "r2": "bf16" if forms & 2 else "general"}


def r1_grid(resident: int, images: int, heads: int, tiles: int) -> int:
    """R1's splits: the blocks that share one (image, head), each walking a
    run of its ``tiles`` and writing one partial. As many as let all
    ``images * heads * splits`` blocks be resident on the card at once (one
    wave: every block does the same work, so a block past the resident
    count would run as a second wave as long as the first), at most one a
    tile, at least one."""
    return max(1, min(tiles, resident // (images * heads)))


def r1_tiles(h: int, w: int, tile: tuple[int, int]) -> int:
    """The tiles of one image that R1 walks: tile (TH, TW), ragged edges
    rounded up."""
    return -(-h // tile[0]) * -(-w // tile[1])


@lru_cache(maxsize=None)
def r1_geometry(code: int, c: int, heads: int, mxu: bool) -> tuple[int, tuple[int, int]]:
    """(resident blocks, (TH, TW)) of R1 (``mxu``: its tap-folded form) for
    dtype ``code`` at (C, heads), from the card's occupancy."""
    out = (ctypes.c_int * 3)()
    err = _lib().restormer_r1_geometry(code, c, heads, int(mxu), out)
    if err:
        raise launch_error("r1_mxu_apply" if mxu else "r1_apply", err)
    return out[0], (out[1], out[2])


def _r1_splits(code: int, c: int, heads: int, b: int, h: int, w: int, mxu: bool) -> int:
    resident, tile = r1_geometry(code, c, heads, mxu)
    return r1_grid(resident, b, heads, r1_tiles(h, w, tile))


def r1_weights(p: dict, bf16_form: bool) -> tuple:
    """R1's params in the kernel's layout, prepared once per parameter
    version (``prepared``): norm1's weight and bias, qkv (3C, C) and its
    taps (3C, 9); in the params' dtype for the bf16 form (the taps float32),
    all float32 for the general form."""
    keys = ("norm1.body.weight", "norm1.body.bias", "attn.qkv.weight", "attn.qkv_dwconv.weight")

    def make(lnw, lnb, wqkv, dw):
        n = wqkv.shape[0]
        if bf16_form:
            return _rows(lnw, 1), _rows(lnb, 1), _rows(wqkv, n), _f32(dw, n)
        return _f32(lnw, 1), _f32(lnb, 1), _f32(wqkv, n), _f32(dw, n)

    return prepared(f"r1 bf16={bf16_form}", tuple(p[k] for k in keys), make)


def r2_weights(p: dict, bf16_form: bool) -> tuple:
    """R2's params in the kernel's layout, prepared once per parameter
    version: project_out (C, C), norm2's weight and bias, project_in (2hp, C)
    and its taps (2hp, 9) in ``_chunk_order``, the GDFN's project_out (C, hp);
    in the params' dtype for the bf16 form (the taps float32), all float32
    for the general form."""
    keys = ("attn.project_out.weight", "norm2.body.weight", "norm2.body.bias",
            "ffn.project_in.weight", "ffn.dwconv.weight", "ffn.project_out.weight")

    def make(wp, lnw, lnb, w_in, dw, w_out):
        c, hidden = w_out.shape[0], w_out.shape[1]
        cast = _rows if bf16_form else _f32
        w_in, w_out = _gdfn_weights(cast(w_in, 2 * hidden), cast(w_out, c), hidden)
        dw = _chunk_order(_f32(dw, 2 * hidden), hidden, hidden_padded(hidden))
        return cast(wp, c), cast(lnw, 1), cast(lnb, 1), w_in, dw, w_out

    return prepared(f"r2 bf16={bf16_form}", tuple(p[k] for k in keys), make)


def r1_mxu_weights(p: dict, bf16_form: bool) -> tuple:
    """R1-mxu's params in the kernel's layout, prepared once per parameter
    version: norm1's weight and bias and the qkv 1x1 with its taps folded
    (``_folded``: folded in float32, rounded to the params' dtype). The bf16
    form takes them in the params' dtype, the folded weight as (heads * 3 *
    hd, 9C): each head's q, k and v rows adjacent, row o of a group holding
    W[i, o] k[dh, dx, o] at column (3 dh + dx) C + i (the kernel streams its
    K-slices into shared memory rows padded for ldmatrix). The general form
    takes float32 copies, the folded weight as (3C, 9C)."""
    keys = ("norm1.body.weight", "norm1.body.bias", "attn.qkv.weight", "attn.qkv_dwconv.weight")
    heads = p["attn.temperature"].shape[0]

    def make(lnw, lnb, wqkv, dw):
        wf = _folded({"attn.qkv.weight": wqkv, "attn.qkv_dwconv.weight": dw},
                     "attn.qkv.weight", "attn.qkv_dwconv.weight").detach().t()
        if not bf16_form:
            return _f32(lnw, 1), _f32(lnb, 1), wf.float().contiguous()
        c = wf.shape[0] // 3
        per_head = wf.reshape(3, heads, c // heads, 9 * c).transpose(0, 1)
        return _rows(lnw, 1), _rows(lnb, 1), per_head.reshape(3 * c, 9 * c).contiguous()

    return prepared(f"r1 mxu bf16={bf16_form}", tuple(p[k] for k in keys), make)


def r2_mxu_weights(p: dict, bf16_form: bool) -> tuple:
    """R2-mxu's params in the kernel's layout, prepared once per parameter
    version: project_out (C, C), norm2's weight and bias, project_in with its
    taps folded (``_folded``) as (2hp, 9C) in ``_chunk_order`` (64 rows a
    chunk of 32 gate pairs), the GDFN's project_out (C, hp); in the params'
    dtype for the bf16 form, all float32 for the general form."""
    def make(wp, lnw, lnb, w_in, dw, w_out):
        c, hidden = w_out.shape[0], w_out.shape[1]
        cast = _rows if bf16_form else _f32
        wf = _folded({"ffn.project_in.weight": w_in, "ffn.dwconv.weight": dw},
                     "ffn.project_in.weight", "ffn.dwconv.weight").detach().t()
        w_in, w_out = _gdfn_weights(cast(wf, 2 * hidden), cast(w_out, c), hidden)
        return cast(wp, c), cast(lnw, 1), cast(lnb, 1), w_in, w_out

    return prepared(f"r2 mxu bf16={bf16_form}", tuple(p[k] for k in R2_KEYS), make)


def _r1_launch(fn, x: torch.Tensor, p: dict, prm: tuple, mxu: bool):
    """Launch R1 (``mxu``: its tap-folded form) with its params ``prm`` in
    the kernel's layout; returns (v, gram, qss, kss)."""
    heads = p["attn.temperature"].shape[0]
    b, h, w, c = x.shape
    hd = c // heads
    v = torch.empty_like(x)
    f32 = dict(device=x.device, dtype=torch.float32)
    gram = torch.empty(b, heads * hd, hd, **f32)
    qss, kss = torch.empty(b, 1, c, **f32), torch.empty(b, 1, c, **f32)
    if x.numel() == 0:
        return v, gram.zero_(), qss.zero_(), kss.zero_()
    code = _DTYPE_CODES[x.dtype]
    splits = _r1_splits(code, c, heads, b, h, w, mxu)
    gram_part = torch.empty(b, splits, heads * hd, hd, **f32)
    ss_part = torch.empty(b, splits, 2, c, **f32)
    ptrs = (ctypes.c_void_p * len(prm))(*(t.data_ptr() for t in prm))
    entry = _lib().restormer_r1_mxu if mxu else _lib().restormer_r1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), ptrs, v.data_ptr(), gram_part.data_ptr(), ss_part.data_ptr(),
                    gram.data_ptr(), qss.data_ptr(), kss.data_ptr(), code, b, h, w, c, heads,
                    splits, stream)
    if err:
        raise launch_error(fn.__name__, err)
    fn.launches += 1
    return v, gram, qss, kss


def r1_apply(x: torch.Tensor, p: dict):
    """R1: (v, gram, qss, kss) of one RestormerBlock's MDTA, as ``r1_plain``.

    Each block of the kernel walks a run of tiles of one image and one head
    and writes its partial gram and sums; a second kernel sums the partials
    in a fixed order, so the result is the same from run to run. The grid
    is one wave (``r1_grid``)."""
    heads, _ = _check("r1_apply", x, {}, p, R1_KEYS)
    if x.device.type == "cpu":
        return r1_plain(x, p)
    refuse_grad("r1_apply", x, *(p[k] for k in R1_KEYS))
    bf16_form = bool(_forms(_DTYPE_CODES[x.dtype], x.shape[-1], heads) & 1)
    prm = r1_weights(p, bf16_form)
    if bf16_form:
        aligned16("r1_apply", {"x": x, **dict(zip(R1_KEYS[:2] + R1_KEYS[3:], prm))})
    return _r1_launch(r1_apply, x, p, prm, False)


r1_apply.launches = 0


def r1_mxu_apply(x: torch.Tensor, p: dict):
    """R1 with the qkv taps folded into the 1x1 (``dw_mxu``), as
    ``r1_mxu_plain``: one product of the tile's nine shifted LN views
    against the folded (9C, 3C) weight, read in place from the LN tile
    (no 9C-wide buffer); the sums and the partial pass as ``r1_apply``."""
    heads, _ = _check("r1_mxu_apply", x, {}, p, R1_KEYS)
    if x.device.type == "cpu":
        return r1_mxu_plain(x, p)
    refuse_grad("r1_mxu_apply", x, *(p[k] for k in R1_KEYS))
    bf16_form = bool(_forms(_DTYPE_CODES[x.dtype], x.shape[-1], heads, True) & 1)
    prm = r1_mxu_weights(p, bf16_form)
    if bf16_form:
        aligned16("r1_mxu_apply", {"x": x, "norm1": prm[0], "norm1 bias": prm[1],
                                   "folded qkv": prm[2]})
    return _r1_launch(r1_mxu_apply, x, p, prm, True)


r1_mxu_apply.launches = 0


def _r2_check(fn: str, x, v, attn, p) -> int:
    """Shapes of R2's activations; returns the hidden width."""
    b, h, w, c = x.shape if x.ndim == 4 else (0, 0, 0, 0)
    if tuple(v.shape) != tuple(x.shape):
        raise ValueError(f"{fn}: v {tuple(v.shape)} is not x's shape {tuple(x.shape)}")
    if attn.ndim != 3 or attn.shape[0] != b or attn.shape[1] != c or c % attn.shape[2]:
        raise ValueError(f"{fn}: attn {tuple(attn.shape)} does not fit x {tuple(x.shape)}")
    return _check(fn, x, {"v": v, "attn": attn}, p, R2_KEYS)[1]


def _r2_launch(fn, x, v, attn, prm: tuple, hidden: int, mxu: bool) -> torch.Tensor:
    """Launch R2 (``mxu``: its tap-folded form) with ``attn`` and the params
    ``prm`` in the kernel's layout."""
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    b, h, w, c = x.shape
    heads = c // attn.shape[-1]
    prm = (attn, *prm)
    ptrs = (ctypes.c_void_p * len(prm))(*(t.data_ptr() for t in prm))
    entry = _lib().restormer_r2_mxu if mxu else _lib().restormer_r2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), v.data_ptr(), ptrs, out.data_ptr(), _DTYPE_CODES[x.dtype], b,
                    h, w, c, heads, hidden_padded(hidden), stream)
    if err:
        raise launch_error(fn.__name__, err)
    fn.launches += 1
    return out


def r2_apply(x: torch.Tensor, v: torch.Tensor, attn: torch.Tensor, p: dict) -> torch.Tensor:
    """R2: attn @ v -> project_out -> +x -> LN2 -> GDFN -> +residual.

    ``attn`` is the glue's (B, heads*hd, hd) in x's dtype."""
    hidden = _r2_check("r2_apply", x, v, attn, p)
    if x.device.type == "cpu":
        return r2_plain(x, v, attn, p)
    refuse_grad("r2_apply", x, v, attn, *(p[k] for k in R2_KEYS))
    c = x.shape[-1]
    bf16_form = bool(_forms(_DTYPE_CODES[x.dtype], c, c // attn.shape[-1]) & 2)
    prm = r2_weights(p, bf16_form)
    if bf16_form:
        aligned16("r2_apply", {"x": x, "v": v, "attn": attn, **dict(zip(R2_KEYS, prm))})
    else:
        attn = attn.float()
    return _r2_launch(r2_apply, x, v, attn, prm, hidden, False)


r2_apply.launches = 0


def r2_mxu_apply(x: torch.Tensor, v: torch.Tensor, attn: torch.Tensor, p: dict) -> torch.Tensor:
    """R2 with project_in's taps folded in (``dw_mxu``), as ``r2_mxu_plain``:
    per chunk of 32 gate pairs one product of the tile's nine shifted LN2
    views against the chunk's (9C, 64) slice of the folded weight."""
    hidden = _r2_check("r2_mxu_apply", x, v, attn, p)
    if x.device.type == "cpu":
        return r2_mxu_plain(x, v, attn, p)
    refuse_grad("r2_mxu_apply", x, v, attn, *(p[k] for k in R2_KEYS))
    c = x.shape[-1]
    bf16_form = bool(_forms(_DTYPE_CODES[x.dtype], c, c // attn.shape[-1], True) & 2)
    prm = r2_mxu_weights(p, bf16_form)
    if bf16_form:
        names = ("project_out", "norm2", "norm2 bias", "folded project_in", "ffn project_out")
        aligned16("r2_mxu_apply", {"x": x, "v": v, "attn": attn, **dict(zip(names, prm))})
    else:
        attn = attn.float()
    return _r2_launch(r2_mxu_apply, x, v, attn, prm, hidden, True)


r2_mxu_apply.launches = 0


# -- the block and the network -----------------------------------------------

def restormer_block_fast(x: torch.Tensor, p: dict, dw_mxu: bool = False) -> torch.Tensor:
    """One RestormerBlock through the fused kernels: R1 -> glue -> R2, or
    with ``dw_mxu`` their tap-folded forms (the JAX flag of the same name)."""
    r1, r2 = (r1_mxu_apply, r2_mxu_apply) if dw_mxu else (r1_apply, r2_apply)
    v, gram, qss, kss = r1(x, p)
    attn = mdta_attention(gram, qss, kss, p["attn.temperature"], x.dtype)
    return r2(x, v, attn, p)


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
