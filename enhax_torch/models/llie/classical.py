"""Classical (non-learned) low-light methods: LIME / DUAL and PIE.

Port of ``enhax/models/llie/classical.py``. Both models are parameter-free
and serve through ``Predictor`` and the predict CLI like any other.

  * LIME / DUAL: the max-channel illumination L is refined by solving
    (Id + lambda F) l = L, F a spatially varying 5-point Laplacian with
    LIME's affinity weights (Sobel differences, reflect-101, over their
    15x15 Gaussian sums, zero-padded). ``exact=True`` (the default) solves
    it with a float64 sparse direct solve (``scipy.sparse.linalg.spsolve``)
    on the host, the algorithm the JAX package runs through
    ``pure_callback`` and the reference runs: the weights span about six
    orders of magnitude, beyond what float32 iterations resolve, so this is
    the method and not a fallback (its weights are computed in float64). ``exact=False`` runs a
    Jacobi-preconditioned BiCGStab on the stencil on the device, in torch,
    as the JAX package's ``jax.scipy.sparse.linalg.bicgstab`` does
    (approximate in float32). DUAL also corrects the inverted image (the
    over-exposure pass) and merges the three by Mertens exposure fusion,
    whose pyramid halves with ``jax.image.resize``'s antialiased linear
    filter (``ops/resize.py``, ``antialias=True``).
  * PIE: an ADMM Retinex decomposition of the HSV value channel (x255),
    two iterations, the R and I subproblems solved by FFT (complex64),
    recombined as R I^(1/2.2).

Images are NHWC. LIME works image by image (each its own solve), PIE on
the batch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.ops.color import hsv_to_rgb, rgb_to_hsv
from enhax_torch.ops.resize import resize

# -- LIME / DUAL ---------------------------------------------------------------


def _gaussian_affinity_kernel(sigma: float, size: int = 15) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    c = size // 2
    return np.exp(-0.5 * ((yy - c) ** 2 + (xx - c) ** 2) / sigma ** 2).astype(np.float32)


def _conv2d_2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The VALID correlation of an (..., H, W) map with a (k, k) kernel."""
    lead = x.shape[:-2]
    y = F.conv2d(x.reshape(-1, 1, *x.shape[-2:]), kernel[None, None])
    return y.reshape(*lead, *y.shape[-2:])


def _conv2_constant(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.convolve(mode='constant')``: zero-padded convolution
    (the kernel flipped) of an (H, W) map."""
    p = kernel.shape[0] // 2
    return _conv2d_2d(F.pad(x, (p, p, p, p)), kernel.flip(0, 1))


def _reflect(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Reflect-101 padding of the last two axes (``jnp.pad(mode='reflect')``)."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (pw, pw, ph, ph), mode="reflect")
    return y.reshape(*lead, *y.shape[-2:])


def _sobel1(L: torch.Tensor, horizontal: bool) -> torch.Tensor:
    """``cv2.Sobel`` with ksize 1 ([-1, 0, 1]), reflect-101 border."""
    if horizontal:
        Lp = _reflect(L, 0, 1)
        return Lp[:, 2:] - Lp[:, :-2]
    Lp = _reflect(L, 1, 0)
    return Lp[2:, :] - Lp[:-2, :]


def _smooth_weights(L: torch.Tensor, horizontal: bool, kernel: torch.Tensor,
                    eps: float = 1e-3) -> torch.Tensor:
    Lp = _sobel1(L, horizontal)
    T = _conv2_constant(torch.ones_like(L), kernel)
    T = T / (_conv2_constant(Lp, kernel).abs() + eps)
    return T / (Lp.abs() + eps)


def lime_matrix(w_up, w_down, w_left, w_right, lambda_: float):
    """(Id + lambda F) as a float64 ``scipy.sparse`` CSR matrix over the
    (H, W) pixels in row order, from numpy neighbour weights: the diagonal
    1 + lambda (the sum of the weights), each neighbour -lambda times its
    weight."""
    import scipy.sparse as sp
    n, m = w_up.shape
    N = n * m
    idx = np.arange(N).reshape(n, m)
    rows, cols = [np.arange(N)], [np.arange(N)]
    data = [1.0 + lambda_ * (w_up + w_down + w_left + w_right).reshape(-1)]
    for wgt, (di, dj) in ((w_up, (-1, 0)), (w_down, (1, 0)), (w_left, (0, -1)),
                          (w_right, (0, 1))):
        src = idx[max(0, -di): n - max(0, di), max(0, -dj): m - max(0, dj)]
        dst = idx[max(0, di): n + min(0, di) or n, max(0, dj): m + min(0, dj) or m]
        wv = wgt[max(0, -di): n - max(0, di), max(0, -dj): m - max(0, dj)]
        rows.append(src.reshape(-1))
        cols.append(dst.reshape(-1))
        data.append(-lambda_ * wv.reshape(-1))
    return sp.csr_matrix((np.concatenate(data), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(N, N))


def bicgstab(matvec, b: torch.Tensor, x0: torch.Tensor, tol: float, maxiter: int,
             precond) -> torch.Tensor:
    """Preconditioned BiCGStab, step for step ``jax.scipy.sparse.linalg.
    bicgstab``: stop once |r|^2 <= tol^2 |b|^2, after ``maxiter`` steps, or
    at a breakdown (rho, alpha or omega 0). Reads |r|^2 on the host once a
    step."""
    def dot(u, v):
        return (u * v).sum()
    atol2 = tol * tol * dot(b, b)
    x = x0
    r = b - matvec(x0)
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    for _ in range(maxiter):
        if not bool(dot(r, r) > atol2):
            break
        rho_ = dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = precond(p)
        q = matvec(phat)
        alpha = rho_ / dot(rhat, q)
        s = r - alpha * q
        exit_early = dot(s, s) < atol2
        shat = precond(s)
        t = matvec(shat)
        omega = dot(t, s) / dot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + alpha * phat + omega * shat)
        r = torch.where(exit_early, s, s - omega * t)
        rho = rho_
        if bool((omega == 0) | (alpha == 0) | (rho_ == 0)):
            break
    return x


def _shift(t: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(t, (dy, dx), dims=(0, 1))


def _inside(L: torch.Tensor) -> tuple:
    """Masks of the pixels whose up, down, left, right neighbour exists."""
    n, m = L.shape
    row = torch.arange(n, device=L.device)[:, None]
    col = torch.arange(m, device=L.device)[None, :]
    return row - 1 >= 0, row + 1 < n, col - 1 >= 0, col + 1 < m


def lime_weights(L: torch.Tensor, sigma: float = 3.0, eps: float = 1e-3) -> tuple:
    """The (up, down, left, right) neighbour weights of an (H, W) map L: a
    neighbour's affinity (the vertical one for up and down), zero where it
    lies outside the image."""
    kernel = torch.from_numpy(_gaussian_affinity_kernel(sigma)).to(L)
    wx = _smooth_weights(L, True, kernel, eps)
    wy = _smooth_weights(L, False, kernel, eps)
    up, down, left, right = _inside(L)
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    return (torch.where(up, _shift(wy, 1, 0), zero), torch.where(down, _shift(wy, -1, 0), zero),
            torch.where(left, _shift(wx, 0, 1), zero), torch.where(right, _shift(wx, 0, -1), zero))


def refine_illumination_lime(L: torch.Tensor, gamma: float = 0.6, lambda_: float = 0.15,
                             sigma: float = 3.0, eps: float = 1e-3, cg_tol: float = 1e-6,
                             cg_maxiter: int = 2000, exact: bool = False) -> torch.Tensor:
    """The refined illumination of an (H, W) map L, clipped to [eps, 1] and
    raised to ``gamma``: the host's float64 direct solve with ``exact``,
    else BiCGStab on the device."""
    if exact:
        import scipy.sparse.linalg as spla
        # the weights in float64 too, for the float64 solve: each is a
        # ratio of small differences that float32 rounds ~1e-5 apart
        host = [w.cpu().numpy() for w in lime_weights(L.detach().double(), sigma, eps)]
        l_ref = spla.spsolve(lime_matrix(*host, lambda_),
                             L.detach().cpu().double().numpy().reshape(-1))
        l_ref = torch.from_numpy(l_ref.reshape(L.shape).astype(np.float32)).to(L)
    else:
        weights = lime_weights(L, sigma, eps)
        masks = _inside(L)
        shifts = ((1, 0), (-1, 0), (0, 1), (0, -1))
        diag = sum(weights)
        zero = torch.zeros((), dtype=L.dtype, device=L.device)

        def matvec(l):
            acc = diag * l
            for w, inside, (dy, dx) in zip(weights, masks, shifts):
                acc = acc - w * torch.where(inside, _shift(l, dy, dx), zero)
            return l + lambda_ * acc

        # F is not symmetric (each off-diagonal is the neighbour's affinity),
        # so BiCGStab and not CG
        inv_diag = 1.0 / (1.0 + lambda_ * diag)
        l_ref = bicgstab(matvec, L, L, cg_tol, cg_maxiter, lambda r: inv_diag * r)
    return torch.clamp(l_ref, eps, 1.0) ** gamma


def mertens_fusion(images: list, bc: float = 1.0, bs: float = 1.0, be: float = 1.0,
                   levels: int | None = None) -> torch.Tensor:
    """Mertens exposure fusion of (H, W, 3) images: contrast, saturation
    (the population std over channels) and well-exposedness weights, then
    Laplacian-pyramid blending."""
    imgs = [im.clamp(0.0, 1.0) for im in images]
    # the weights in float64, cast after the normalisation: where every
    # image's Laplacian is near 0, each weight is a ratio of products that
    # float32 rounds far apart (4e-6-2.5e-5 from float64 on a 37x29 draw)
    lap = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float64,
                       device=imgs[0].device)
    weights = []
    for im in imgs:
        im64 = im.double()
        contrast = _conv2d_2d(_reflect(im64.mean(-1), 1, 1), lap).abs() ** bc
        saturation = im64.std(-1, correction=0) ** bs
        wellexp = torch.exp(-((im64 - 0.5) ** 2) / 0.08).prod(-1) ** be
        weights.append(contrast * saturation * wellexp + 1e-12)
    wsum = sum(weights)
    weights = [(w / wsum).to(imgs[0].dtype) for w in weights]

    h, w = imgs[0].shape[:2]
    if levels is None:
        levels = max(int(np.floor(np.log2(min(h, w)))) - 3, 1)

    def down(x):   # (H, W, C): halved, rounding down, with the antialiased filter
        return resize(x, (max(x.shape[0] // 2, 1), max(x.shape[1] // 2, 1)), antialias=True)

    def up(x, shape):
        return resize(x, tuple(shape[:2]))

    fused = None
    for im, wgt in zip(imgs, weights):
        gp_w, gp_i = [wgt[..., None]], [im]
        for _ in range(levels):
            gp_w.append(down(gp_w[-1]))
            gp_i.append(down(gp_i[-1]))
        lp_i = [gp_i[k] - up(gp_i[k + 1], gp_i[k].shape) for k in range(levels)] + [gp_i[-1]]
        contrib = [lp_i[k] * gp_w[k] for k in range(levels + 1)]
        fused = contrib if fused is None else [f + c for f, c in zip(fused, contrib)]
    out = fused[-1]
    for k in range(levels - 1, -1, -1):
        out = up(out, fused[k].shape) + fused[k]
    return out.clamp(0.0, 1.0)


class LIMEModule(nn.Module):
    """LIME (``dual=False``) or DUAL (``dual=True``) on NHWC images."""

    def __init__(self, gamma: float = 0.6, lambda_: float = 0.15, sigma: float = 3.0,
                 dual: bool = True, exact: bool = True):
        super().__init__()
        self.gamma, self.lambda_, self.sigma = gamma, lambda_, sigma
        self.dual, self.exact = dual, exact

    def correct(self, im: torch.Tensor) -> torch.Tensor:
        l_ref = refine_illumination_lime(im.amax(-1), self.gamma, self.lambda_, self.sigma,
                                         exact=self.exact)
        return im / l_ref[..., None]

    def one(self, im: torch.Tensor) -> torch.Tensor:
        under = self.correct(im)
        if not self.dual:
            return under.clamp(0.0, 1.0)
        over = 1.0 - self.correct(1.0 - im)
        return mertens_fusion([im, under, over])

    def forward(self, image: torch.Tensor) -> dict:
        return {"enhanced": torch.stack([self.one(im) for im in image])}


# -- PIE -----------------------------------------------------------------------

def _psf2otf_1d(shape: tuple) -> tuple:
    """The reference's OTFs of the two difference filters, computed on the
    enlarged (H, W + 1) / (H + 1, W) grids and sliced, complex64."""
    h, w = shape
    fv = np.zeros((h, w + 1), np.float64)
    fv[0, 0], fv[0, 1] = 1.0, -1.0
    fdV = np.fft.fft2(np.roll(fv, -1, axis=1))[:, 1:]
    fh = np.zeros((h + 1, w), np.float64)
    fh[0, 0], fh[1, 0] = 1.0, -1.0
    fdH = np.fft.fft2(np.roll(fh, -1, axis=0))[1:, :]
    return fdH.astype(np.complex64), fdV.astype(np.complex64)


def _gaussian_blur5(x: torch.Tensor) -> torch.Tensor:
    """``cv2.GaussianBlur(ksize=5, sigma=0)``: cv2's fixed [1, 4, 6, 4, 1] / 16,
    reflect-101."""
    k1 = torch.tensor([0.0625, 0.25, 0.375, 0.25, 0.0625], dtype=x.dtype, device=x.device)
    return _conv2d_2d(_reflect(x, 2, 2), torch.outer(k1, k1))


def _sobel3(x: torch.Tensor, horizontal: bool) -> torch.Tensor:
    """``cv2.Sobel`` 3x3, reflect-101."""
    d = torch.tensor([-1.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
    s = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = torch.outer(s, d) if horizontal else torch.outer(d, s)
    return _conv2d_2d(_reflect(x, 1, 1), k)


def pie_enhance_v(v: torch.Tensor, alpha: float = 1000.0, beta: float = 0.01, lam: float = 10.0,
                  gama: float = 0.1, iters: int = 2) -> torch.Tensor:
    """The reference's ADMM on (..., H, W) value channels in [0, 255]."""
    eps = 1e-10
    fdH, fdV = (torch.from_numpy(a).to(v.device) for a in _psf2otf_1d(v.shape[-2:]))
    fdHcj, fdVcj = fdH.conj(), fdV.conj()
    otf2 = fdH.abs() ** 2 + fdV.abs() ** 2
    I = _gaussian_blur5(v)
    I0 = v.mean((-2, -1), keepdim=True)
    R = torch.zeros_like(v)
    bv = torch.zeros_like(v)
    bh = torch.zeros_like(v)

    def shrink(x, t):
        return x / (x.abs() + eps) * torch.clamp_min(x.abs() - t, 0.0)

    fft2, ifft2 = torch.fft.fft2, torch.fft.ifft2
    for _ in range(iters):
        dv = shrink(_sobel3(R, True) + bv, 1.0 / (2 * lam))
        dh = shrink(_sobel3(R, False) + bh, 1.0 / (2 * lam))
        difv, difh = dv - bv, dh - bh
        ahp = beta * lam
        Fi = fdVcj * fft2(difv) + fdHcj * fft2(difh)
        f1 = fft2(v / (I + eps)) + ahp * Fi
        R = ifft2(f1 / (otf2 * ahp + 1.0)).abs().clamp(0.0, 1.0).to(v.dtype)
        bv = _sobel3(R, True) - difv
        bh = _sobel3(R, False) - difh
        f1 = fft2(gama * I0 + v / (R + eps))
        I = ifft2(f1 / (alpha * otf2 + gama + 1.0)).abs()
        I = torch.maximum(I.clamp(0.0, 255.0), v).to(v.dtype)
    I = 255.0 * torch.pow(I / 255.0, 1.0 / 2.2)
    return R * I


class PIEModule(nn.Module):
    def forward(self, image: torch.Tensor) -> dict:
        hsv = rgb_to_hsv(image)
        v_new = pie_enhance_v(hsv[..., 2] * 255.0) / 255.0
        out = hsv_to_rgb(torch.cat([hsv[..., 0:2], v_new.clamp(0.0, 1.0)[..., None]], -1))
        return {"enhanced": out.clamp(0.0, 1.0)}


@MODELS.register(name="lime", arch="lime", aliases=["dual"], tasks=(Task.LLIE,),
                 schemes=(Scheme.TRADITIONAL,))
def lime(gamma: float = 0.6, lambda_: float = 0.15, sigma: float = 3.0, dual: bool = True,
         exact: bool = True, **kwargs) -> Model:
    return Model(
        name="lime", arch="lime",
        module=LIMEModule(gamma=gamma, lambda_=lambda_, sigma=sigma, dual=dual, exact=exact),
        tasks=(Task.LLIE,), schemes=(Scheme.TRADITIONAL,),
        required_inputs=("image",),
        size_divisor=1,
    )


@MODELS.register(name="pie", arch="pie", tasks=(Task.LLIE,), schemes=(Scheme.TRADITIONAL,))
def pie(**kwargs) -> Model:
    return Model(
        name="pie", arch="pie", module=PIEModule(),
        tasks=(Task.LLIE,), schemes=(Scheme.TRADITIONAL,),
        required_inputs=("image",),
        size_divisor=1,
    )
