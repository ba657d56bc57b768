"""ECC (Enhanced Correlation Coefficient) translation alignment.

Port of ``siriltpu.ops.ecc``. Reference: src/opencv/ecc/ecc.cpp
(``findTransform_ECC`` :307-554, the Siril wrapper ``findTransform``
:556-603) implementing Evangelidis & Psarakis, PAMI 2008, translation
warp only as used by ``register_ecc``
(src/registration/registration.c:786-930).

Frozen behaviors:

- both images are saturated to 8-bit before alignment (findTransform
  converts CV_16U -> CV_8U, ecc.cpp:568-569);
- 5x5 fixed-kernel Gaussian smoothing of template and input (:401-415);
- centered [-0.5, 0, 0.5] gradients of the smoothed input (:423-426);
- per iteration: inverse-map bilinear warp of image and gradients by the
  current translation, nearest-warp of the validity mask, masked
  zero-means, rho = corr/(|img||tmp|), illumination-compensation lambda,
  2-parameter Gauss-Newton update dp = H^-1 J^T (lambda*t - i) (:449-552);
- at most 50 iterations, stop when |rho - last_rho| < 0.001 (:562-563);
- failure (rho <= 0) excludes the frame; the caller stores
  shiftx = -round(dx), shifty = -round(dy) (registration.c:906-908).

The iteration is written once, for a batch of frames against one
template: every pass runs on all frames and updates only those still
active, until none is (one host sync a pass), as ``jax.vmap`` of the JAX
package's ``while_loop`` does. All of it is float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from siriltpu_torch.ops.interp import (cv_gradient_x, cv_gradient_y,
                                       gaussian_blur5)

Tensor = torch.Tensor

NUM_ITERATIONS = 50
TERMINATION_EPS = 0.001

# max |translation| the slice warp supports; each image is padded by this
# much. Planetary ECC drifts are tens of pixels; the reference has no
# larger reach either (it starts from identity and must converge in 50
# Gauss-Newton steps).
MAX_SHIFT = 64


def ecc_translation_batch(template: Tensor, images: Tensor):
    """Align every (H, W) frame of ``images`` (F, H, W) to ``template``
    with a translation warp, on the tensors' device.

    Inputs are float tensors (already 8-bit-saturated by the caller for
    reference parity). Returns (tx, ty, rho), each (F,) float32: the
    translation stored in the warp matrix (dst(x,y) = image(x+tx, y+ty))
    and the final ECC.

    A translation moves every pixel by the same offset, so the bilinear
    inverse map is one (H + 1, W + 1) window of a zero-padded copy, at a
    per-frame offset, plus a 4-tap blend; zero padding reproduces OpenCV's
    BORDER_CONSTANT blend exactly for |t| < MAX_SHIFT.
    """
    f, h, w = images.shape
    dev = images.device
    M = MAX_SHIFT
    tf = gaussian_blur5(template.to(torch.float32))
    imf = gaussian_blur5(images.to(torch.float32))
    padded = torch.nn.functional.pad(
        torch.stack([imf, cv_gradient_x(imf), cv_gradient_y(imf)], dim=1),
        (M, M + 1, M, M + 1))
    del imf
    frame = torch.arange(f, device=dev)[:, None, None, None]
    plane = torch.arange(3, device=dev)[None, :, None, None]
    rows = torch.arange(h + 1, device=dev)[None, None, :, None]
    cols = torch.arange(w + 1, device=dev)[None, None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    one = torch.ones((), dtype=torch.float32, device=dev)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)

    def col(x):          # (F,) -> (F, 1, 1)
        return x[:, None, None]

    def total(x):        # per-frame sum over the image
        return x.sum(dim=(1, 2))

    def warp3(tx, ty):
        k = torch.floor(tx)
        l = torch.floor(ty)
        fx = col(tx - k)[:, None]
        fy = col(ty - l)[:, None]
        r0 = (M + l).to(torch.int64)[:, None, None, None]
        c0 = (M + k).to(torch.int64)[:, None, None, None]
        win = padded[frame, plane, r0 + rows, c0 + cols]
        v00 = win[:, :, :h, :w]
        v01 = win[:, :, :h, 1:]
        v10 = win[:, :, 1:, :w]
        v11 = win[:, :, 1:, 1:]
        top = v00 * (1 - fx) + v01 * fx
        bot = v10 * (1 - fx) + v11 * fx
        return top * (1 - fy) + bot * fy

    it = torch.ones(f, dtype=torch.int32, device=dev)
    tx = torch.zeros(f, dtype=torch.float32, device=dev)
    ty = torch.zeros_like(tx)
    rho = torch.full_like(tx, -1.0)
    last_rho = torch.full_like(tx, -TERMINATION_EPS)
    while True:
        active = (it <= NUM_ITERATIONS) & (
            torch.abs(rho - last_rho) >= TERMINATION_EPS)
        # one host sync a pass: the loop runs until no frame is active
        if not bool(active.any()):
            break
        txc = tx.clamp(-(M - 1.0), M - 1.0)
        tyc = ty.clamp(-(M - 1.0), M - 1.0)
        warped, gxw, gyw = warp3(txc, tyc).unbind(dim=1)
        # translate_mask, frame by frame: the nearest-warped valid region
        xi = torch.floor(xx + col(txc) + 0.5)
        yi = torch.floor(yy + col(tyc) + 0.5)
        mask = ((xi >= 0) & (xi < w)) & ((yi >= 0) & (yi < h))
        nnz = total(mask).to(torch.float32)
        mnz = torch.clamp(nnz, min=1.0)

        img_mean = total(torch.where(mask, warped, 0.0)) / mnz
        tmp_mean = total(torch.where(mask, tf, 0.0)) / mnz
        di = warped - col(img_mean)
        dt = tf - col(tmp_mean)
        img_var = total(torch.where(mask, di * di, 0.0)) / mnz
        tmp_var = total(torch.where(mask, dt * dt, 0.0)) / mnz

        iw = torch.where(mask, di, 0.0)
        tzm = torch.where(mask, dt, 0.0)
        img_norm = torch.sqrt(nnz * img_var)
        tmp_norm = torch.sqrt(nnz * tmp_var)

        # 2x2 Hessian of the translation Jacobian [gx, gy]
        hxx = total(gxw * gxw)
        hxy = total(gxw * gyw)
        hyy = total(gyw * gyw)
        det = hxx * hyy - hxy * hxy
        # OpenCV Mat::inv returns zeros for singular matrices
        inv_det = torch.where(det != 0, one / det, 0.0)
        i00, i01, i11 = hyy * inv_det, -hxy * inv_det, hxx * inv_det

        corr = total(tzm * warped)  # templateZM.dot(imageWarped)
        new_rho = corr / torch.maximum(img_norm * tmp_norm, tiny)

        tpx = total(gxw * tzm)
        tpy = total(gyw * tzm)
        ipx = total(gxw * iw)
        ipy = total(gyw * iw)
        iphx = i00 * ipx + i01 * ipy
        iphy = i01 * ipx + i11 * ipy
        lambda_n = img_norm * img_norm - (ipx * iphx + ipy * iphy)
        lambda_d = corr - (tpx * iphx + tpy * iphy)
        lam = lambda_n / torch.where(lambda_d == 0, tiny, lambda_d)
        new_rho = torch.where(lambda_d <= 0.0, -one, new_rho)

        err = col(lam) * tzm - iw
        epx = total(gxw * err)
        epy = total(gyw * err)
        dpx = i00 * epx + i01 * epy
        dpy = i01 * epx + i11 * epy

        it = torch.where(active, it + 1, it)
        tx = torch.where(active, txc + dpx, tx)
        ty = torch.where(active, tyc + dpy, ty)
        last_rho = torch.where(active, rho, last_rho)
        rho = torch.where(active, new_rho, rho)
    return tx, ty, rho


def ecc_translation(template: Tensor, image: Tensor):
    """Align one 2D ``image`` to ``template``; see ecc_translation_batch.
    Returns 0-d tensors (tx, ty, rho)."""
    tx, ty, rho = ecc_translation_batch(template, image[None])
    return tx[0], ty[0], rho[0]


def ecc_find_translation(ref_layer: np.ndarray, img_layer: np.ndarray, *,
                         device) -> Tuple[float, float, float]:
    """Siril's ``findTransform``: saturate to 8-bit, run ECC translation
    on ``device``. Returns (dx, dy, rho); rho <= 0 means failure (frame
    excluded)."""
    ref8 = np.minimum(np.asarray(ref_layer), 255).astype(np.float32)
    img8 = np.minimum(np.asarray(img_layer), 255).astype(np.float32)
    tx, ty, rho = ecc_translation(torch.from_numpy(ref8).to(device),
                                  torch.from_numpy(img8).to(device))
    return float(tx), float(ty), float(rho)


__all__ = ["ecc_translation", "ecc_find_translation", "ecc_translation_batch",
           "NUM_ITERATIONS", "TERMINATION_EPS"]
