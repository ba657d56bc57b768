"""Elliptical-Gaussian PSF fitting with Levenberg–Marquardt, batched over
stars.

Port of ``siriltpu.ops.psf``. Reference: src/algos/PSF.c.

Model (no angle, :160-187): f(i,j) = B + A·exp(−((tx−x0)²/SX + (ty−y0)²/SY))
with tx = j+1, ty = i+1 over the box (1-based grid).
Model (angle, :230-309): coordinates rotated about (x0, y0) by alpha.

Initialization (``psf_init_data`` :92-139): find the max after 3×3
neighbor-median hot-pixel suppression (:47-89), then walk out along the
max row/column while pixel−bg > (max−bg)/2; x0,y0 = midpoints (+1), and
SX, SY = trunc(extent²/(4 ln 2)).

Fit: GSL lmsder, at most 10 iterations (:40-41), delta test 1e-4/1e-4.
Like the JAX package we implement classical Levenberg-Marquardt with the
same analytic Jacobians (:189-220, :262-301), same iteration cap and the
same gsl_multifit_test_delta stopping rule — numerically equivalent within
the acceptance tolerances of ``is_star`` (star_finder.c:59-78), not
bit-identical to GSL's trust-region internals.

Post-processing (``psf_global_minimisation`` :620-662): optional angle
refit when |sx−sy| ≥ 0.01, symmetry fix to sx ≥ sy with ±90° angle fold,
B/A/RMSE normalized by the image norm value, FWHM = sqrt(S/2)·2·sqrt(2 ln2),
magnitude = −2.5·log10(Σ(z−B)) (:145-155).

Every function works on a batch of (N, h, w) boxes at once: a pass of the
LM loop runs on all boxes and updates only those not yet converged, as
``jax.vmap`` of the JAX package's ``while_loop`` does. All of it is
float32; the normal equations are plain float32 products (never TF32:
``torch.backends.cuda.matmul.allow_tf32`` stays off).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

MAX_ITER = 10     # PSF.c:40-41
EPSILON_ANGLE = 0.01
_FWHM_K = float(2.0 * np.sqrt(np.log(2.0) * 2.0))


class PSFFit(NamedTuple):
    """Fitted parameters, one per star (all (N,) tensors)."""
    B: Tensor
    A: Tensor
    x0: Tensor
    y0: Tensor
    sx: Tensor
    sy: Tensor
    angle: Tensor
    fwhmx: Tensor
    fwhmy: Tensor
    rmse: Tensor
    mag: Tensor
    ok: Tensor  # n > p and finite results


# ------------------------------------------------------------------- init

def _median3x3_neighbors(z: Tensor) -> Tensor:
    """3×3 neighbor median (center excluded) of every (h, w) box of
    ``z`` (N, h, w), used for hot-pixel suppression before locating the
    max (PSF.c:47-89). Interior pixels take the GSL median of their 8
    neighbors; the reference's border handling reads one stray zero into
    the window (start = 8-n-1), which we reproduce by zero-padding and
    keeping window size 9−1."""
    _, h, w = z.shape
    p = torch.nn.functional.pad(z, (1, 1, 1, 1))
    taps = [p[:, dy: dy + h, dx: dx + w]
            for dy in (0, 1, 2) for dx in (0, 1, 2) if (dy, dx) != (1, 1)]
    s = torch.sort(torch.stack(taps, dim=1), dim=1).values   # (N, 8, h, w)
    # interior: median of 8 = mean of 4th/5th order stats.
    # (the reference reads out of bounds here — UB; we use the sane median)
    return 0.5 * (s[:, 3] + s[:, 4])


def _init_params(z: Tensor, bg: Tensor) -> Tensor:
    """psf_init_data (PSF.c:92-139) for (N, h, w) boxes and (N,)
    backgrounds: (N, 6) float32 (B, A, x0, y0, SX, SY)."""
    n, h, w = z.shape
    dev = z.device
    filt = _median3x3_neighbors(z)
    idx = torch.argmax(filt.reshape(n, -1), dim=1)   # the first maximum
    iy = idx // w
    ix = idx % w
    box = torch.arange(n, device=dev)
    peak = z[box, iy, ix]
    half = peak - bg

    def walk(values, center, size):
        # the C loop `while (2*(z[ii1]) > half && ii1 < N-1) ii1++` stops
        # AT the first failing index (or N-1), and likewise downwards
        pos = torch.arange(size, device=dev)[None, :]
        cond = 2.0 * values > half[:, None]
        after = torch.where((pos > center[:, None]) & ~cond, pos, size)
        stop_hi = after.amin(dim=1)
        hi = torch.where(stop_hi <= size - 1, stop_hi, size - 1)
        before = torch.where((pos < center[:, None]) & ~cond, pos, -1)
        lo = before.amax(dim=1).clamp(min=0)
        return lo, hi

    ii2, ii1 = walk(z[box, :, ix] - bg[:, None], iy, h)
    jj2, jj1 = walk(z[box, iy, :] - bg[:, None], ix, w)
    x0 = (jj1 + jj2 + 2).to(torch.float32) / 2.0
    y0 = (ii1 + ii2 + 2).to(torch.float32) / 2.0
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float32, device=dev)
    # (size_t) cast truncates
    sy0 = torch.floor(((ii1 - ii2) ** 2).to(torch.float32) / 4.0 / ln2)
    sx0 = torch.floor(((jj1 - jj2) ** 2).to(torch.float32) / 4.0 / ln2)
    return torch.stack([bg, peak, x0, y0, sx0.clamp(min=1.0),
                        sy0.clamp(min=1.0)], dim=1)


# ----------------------------------------------------------------- residual

def _cols(params: Tensor):
    """(N, P) parameters -> P tensors of (N, 1, 1), to broadcast over a
    box."""
    return [c[:, None, None] for c in params.unbind(dim=1)]


def _resid_jac_no_angle(params: Tensor, tx: Tensor, ty: Tensor, y: Tensor):
    B, A, x0, y0, sx, sy = _cols(params)
    e = torch.exp(-(((tx - x0) ** 2) / sx + ((ty - y0) ** 2) / sy))
    r = B + A * e - y
    J = torch.stack([
        torch.ones_like(e),
        e,
        A * e * 2.0 * (tx - x0) / sx,
        A * e * 2.0 * (ty - y0) / sy,
        A * e * (tx - x0) ** 2 / sx ** 2,
        A * e * (ty - y0) ** 2 / sy ** 2,
    ], dim=-1)
    return r, J


def _resid_jac_angle(params: Tensor, tx0: Tensor, ty0: Tensor, y: Tensor):
    B, A, x0, y0, sx, sy, al = _cols(params)
    ca, sa = torch.cos(al), torch.sin(al)
    tx = ca * (tx0 - x0) - sa * (ty0 - y0) + x0
    ty = sa * (tx0 - x0) + ca * (ty0 - y0) + y0
    e = torch.exp(-(((tx - x0) ** 2) / sx + ((ty - y0) ** 2) / sy))
    r = B + A * e - y
    dxr = -sa * (tx0 - x0) - ca * (ty0 - y0)
    dyr = ca * (tx0 - x0) - sa * (ty0 - y0)
    J = torch.stack([
        torch.ones_like(e),
        e,
        A * e * 2.0 * (tx - x0) / sx * ca,
        A * e * 2.0 * (ty - y0) / sy * ca,
        A * e * (tx - x0) ** 2 / sx ** 2,
        A * e * (ty - y0) ** 2 / sy ** 2,
        -A * e * (2.0 * (tx - x0) / sx * dxr + 2.0 * (ty - y0) / sy * dyr),
    ], dim=-1)
    return r, J


def _lm_fit(resid_jac, params0: Tensor, args, max_iter: int = MAX_ITER):
    """Classical LM with diagonal damping and the GSL delta test, on
    (N, P) parameters. Returns ((N, P) parameters, (N,) rmse)."""
    n, nparams = params0.shape
    p = params0
    lam = torch.full((n,), 1e-3, dtype=torch.float32, device=p.device)
    done = torch.zeros(n, dtype=torch.bool, device=p.device)
    for _ in range(max_iter):
        # one host sync a pass: the loop runs until every box converged
        if bool(done.all()):
            break
        r, J = resid_jac(p, *args)
        Jm = J.reshape(n, -1, nparams)
        JT = Jm.transpose(1, 2)
        g = torch.matmul(JT, r.reshape(n, -1, 1))
        H = torch.matmul(JT, Jm)
        D = torch.diag_embed(
            torch.diagonal(H, dim1=1, dim2=2).clamp(min=1e-12))
        # a singular system gives inf/nan and no error, as jnp.linalg.solve
        # does; the ``improved`` test then rejects the step
        step = torch.linalg.solve_ex(H + lam[:, None, None] * D, -g,
                                     check_errors=False).result[:, :, 0]
        newp = p + step
        old_cost = (r * r).sum(dim=(1, 2))
        rn, _ = resid_jac(newp, *args)
        new_cost = (rn * rn).sum(dim=(1, 2))
        improved = (new_cost < old_cost) & torch.isfinite(newp).all(dim=1)
        # gsl_multifit_test_delta(dx, x, 1e-4, 1e-4)
        converged = improved & (
            torch.abs(step) < 1e-4 + 1e-4 * torch.abs(newp)).all(dim=1)
        p = torch.where((improved & ~done)[:, None], newp, p)
        lam = torch.where(done, lam,
                          torch.where(improved, lam * 0.3, lam * 10.0))
        done = done | converged
    r, _ = resid_jac(p, *args)
    return p, torch.sqrt((r * r).mean(dim=(1, 2)))


# ------------------------------------------------------------------ fitting

def _fit_boxes(z: Tensor, bg: Tensor, fit_angle: bool):
    """Fit (N, h, w) float32 boxes. Returns the 7 parameters, rmse and
    mag, each (N,)."""
    n, h, w = z.shape
    dev = z.device
    ty = torch.arange(1, h + 1, dtype=torch.float32, device=dev)[None, :, None]
    tx = torch.arange(1, w + 1, dtype=torch.float32, device=dev)[None, None, :]
    p, rmse = _lm_fit(_resid_jac_no_angle, _init_params(z, bg), (tx, ty, z))
    pa = torch.cat([p, torch.zeros((n, 1), dtype=p.dtype, device=dev)], dim=1)
    angle = torch.zeros(n, dtype=torch.float32, device=dev)
    if fit_angle:
        # the refit runs on every box and is kept where |sx - sy| calls
        # for it (PSF.c:626), as the JAX package's lax.cond under vmap
        need = torch.abs(p[:, 4] - p[:, 5]) >= EPSILON_ANGLE
        pa_fit, rmse_a = _lm_fit(_resid_jac_angle, pa, (tx, ty, z))
        pa = torch.where(need[:, None], pa_fit, pa)
        rmse = torch.where(need, rmse_a, rmse)
        # angle in degrees, folded into [-90, 90] (PSF.c:512-523)
        angle = -pa[:, 6] * (180.0 / math.pi)
        while True:
            # one host sync a fold; an infinite angle would never fold
            over = torch.isfinite(angle) & (torch.abs(angle) > 90.0)
            if not bool(over.any()):
                break
            angle = torch.where(
                over, torch.where(angle > 0.0, angle - 90.0, angle + 90.0),
                angle)
    B, A, x0, y0, sx, sy = pa[:, :6].unbind(dim=1)
    # symmetry fix: sx >= sy, angle folding (PSF.c:636-644)
    swap = sy > sx
    sx, sy = torch.where(swap, sy, sx), torch.where(swap, sx, sy)
    angle = torch.where(
        swap & (angle != 0.0),
        torch.where(angle > 0.0, angle - 90.0, angle + 90.0), angle)
    mag = -2.5 * torch.log10(
        (z - B[:, None, None]).sum(dim=(1, 2)).clamp(min=1e-30))
    return B, A, x0, y0, sx, sy, angle, rmse, mag


def fit_psf_batch(boxes: Tensor, bgs: Tensor, fit_angle: bool = False,
                  norm: float = 65535.0) -> PSFFit:
    """Fit a batch of star boxes (N, h, w) with backgrounds (N,), on the
    tensors' device.

    Returns a PSFFit of (N,) tensors; B/A/rmse normalized by ``norm``
    (psf_global_minimisation :647-650)."""
    _, h, w = boxes.shape
    boxes = boxes.to(torch.float32)
    B, A, x0, y0, sx, sy, angle, rmse, mag = _fit_boxes(
        boxes, bgs.to(torch.float32), fit_angle)
    fwhmx = torch.sqrt(sx / 2.0) * _FWHM_K
    fwhmy = torch.sqrt(sy / 2.0) * _FWHM_K
    ok = h * w > (7 if fit_angle else 6)
    okv = (torch.isfinite(fwhmx) & torch.isfinite(fwhmy)
           & (fwhmx > 0) & (fwhmy > 0) & ok)
    # a tensor divisor: on a CUDA device, division by a Python scalar is a
    # product with its reciprocal
    norm = torch.tensor(norm, dtype=torch.float32, device=boxes.device)
    return PSFFit(B=B / norm, A=A / norm, x0=x0, y0=y0, sx=sx, sy=sy,
                  angle=angle, fwhmx=fwhmx, fwhmy=fwhmy, rmse=rmse / norm,
                  mag=mag, ok=okv)


FIT_FIELDS = ("B", "A", "x0", "y0", "sx", "sy", "angle", "fwhmx", "fwhmy",
              "rmse", "mag")


def fit_psf_single(z: np.ndarray, bg: float, *, device,
                   fit_angle: bool = True,
                   norm: float = 65535.0) -> Optional[dict]:
    """One-box convenience wrapper (psf_global_minimisation semantics),
    the fit on ``device``. Returns a dict or None if the fit is
    invalid."""
    z = np.asarray(z, dtype=np.float32)
    if z.size <= (7 if fit_angle else 6):
        return None
    r = fit_psf_batch(torch.from_numpy(z)[None].to(device),
                      torch.tensor([bg], dtype=torch.float32, device=device),
                      fit_angle=fit_angle, norm=norm)
    if not bool(r.ok[0]):
        return None
    return {k: float(getattr(r, k)[0]) for k in FIT_FIELDS}


__all__ = ["fit_psf_batch", "fit_psf_single", "PSFFit", "MAX_ITER"]
