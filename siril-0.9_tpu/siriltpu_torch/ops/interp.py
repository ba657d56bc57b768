"""Image sampling primitives: bilinear/nearest gathers, OpenCV-style
separable filters, shared by ECC alignment and (later) homography warps.

Port of ``siriltpu.ops.interp``. OpenCV semantics reproduced where the
reference relies on them:

- ``filter2D`` correlation with BORDER_REFLECT_101 (``gfe|abcdefg|edc``);
- ``GaussianBlur(ksize=5, sigma=0)`` uses OpenCV's fixed small-kernel
  table [1, 4, 6, 4, 1]/16 (getGaussianKernel small_gaussian_tab);
- ``warpAffine(..., WARP_INVERSE_MAP, INTER_LINEAR)`` with constant-0
  border: dst(x, y) = src(M @ (x, y, 1)), bilinear, 0 outside.

The filters take (..., H, W) float tensors and work on the last two axes,
so a batch of frames is filtered in one call; the taps are summed in the
JAX package's order, each product and each sum one float32 operation.
"""

from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor

GAUSS5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
_GRADIENT = (-0.5, 0.0, 0.5)


def _reflect101_pad(x: Tensor, r: int, axis: int) -> Tensor:
    """BORDER_REFLECT_101 padding by r along axis."""
    n = x.shape[axis]
    lo = x.narrow(axis, 1, r).flip(axis)
    hi = x.narrow(axis, n - 1 - r, r).flip(axis)
    return torch.cat([lo, x, hi], dim=axis)


def _filter_axis(x: Tensor, k: Sequence[float], axis: int) -> Tensor:
    if len(k) == 1:
        return k[0] * x
    n = x.shape[axis]
    p = _reflect101_pad(x, len(k) // 2, axis)
    out = k[0] * p.narrow(axis, 0, n)
    for i in range(1, len(k)):
        out = out + k[i] * p.narrow(axis, i, n)
    return out


def sep_filter(img: Tensor, kx: Sequence[float], ky: Sequence[float]) -> Tensor:
    """Separable correlation filter with reflect-101 borders on the last
    two axes: ``ky`` down the rows first, then ``kx`` along them."""
    return _filter_axis(_filter_axis(img, ky, -2), kx, -1)


def gaussian_blur5(img: Tensor) -> Tensor:
    """OpenCV GaussianBlur(Size(5,5), 0): separable [1,4,6,4,1]/16."""
    return sep_filter(img, GAUSS5, GAUSS5)


def cv_gradient_x(img: Tensor) -> Tensor:
    """filter2D with Matx13f(-0.5, 0, 0.5): 0.5*(src[x+1] - src[x-1])."""
    return sep_filter(img, _GRADIENT, (1.0,))


def cv_gradient_y(img: Tensor) -> Tensor:
    return sep_filter(img, (1.0,), _GRADIENT)


def bilinear_sample(img: Tensor, xs: Tensor, ys: Tensor,
                    fill: float = 0.0) -> Tensor:
    """Bilinear gather from a 2D image at float coords (x, y);
    out-of-bounds -> fill.

    Matches OpenCV INTER_LINEAR + BORDER_CONSTANT: any sample whose 2x2
    support touches outside pixels blends with the border value.
    """
    h, w = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return torch.where(inb, img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)],
                           fill)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def nearest_sample(img: Tensor, xs: Tensor, ys: Tensor,
                   fill: float = 0.0) -> Tensor:
    """INTER_NEAREST with constant border (round to nearest, half up)."""
    h, w = img.shape
    xi = torch.floor(xs + 0.5).to(torch.int64)
    yi = torch.floor(ys + 0.5).to(torch.int64)
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    return torch.where(inb, img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)], fill)


def _grid(shape, device):
    h, w = shape
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy.expand(h, w), xx.expand(h, w)


def translate_bilinear(img: Tensor, tx, ty, fill: float = 0.0) -> Tensor:
    """warpAffine inverse-map for pure translation:
    dst(x, y) = img(x + tx, y + ty), bilinear, constant border."""
    yy, xx = _grid(img.shape, img.device)
    return bilinear_sample(img, xx + tx, yy + ty, fill)


def translate_mask(shape, tx, ty, *, device) -> Tensor:
    """Nearest-warped all-ones mask for a translation (valid region)."""
    h, w = shape
    yy, xx = _grid(shape, device)
    xi = torch.floor(xx + tx + 0.5)
    yi = torch.floor(yy + ty + 0.5)
    return (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)


__all__ = ["gaussian_blur5", "cv_gradient_x", "cv_gradient_y",
           "bilinear_sample", "nearest_sample", "translate_bilinear",
           "translate_mask", "sep_filter"]
