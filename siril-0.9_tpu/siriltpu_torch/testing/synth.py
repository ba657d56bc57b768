"""Synthetic astronomical test data: Gaussian starfields, gradients,
noise, hot pixels — the fixtures for golden tests (SURVEY §4: the
reference ships no tests; configs are validated against oracle
implementations on synthetic data).

Port of ``siriltpu.testing.synth`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame


def gaussian_star(h: int, w: int, x0: float, y0: float, amp: float,
                  sx: float, sy: float, angle: float = 0.0) -> np.ndarray:
    """Elliptical Gaussian star (same model as the PSF fit, PSF.c:160-309)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dx, dy = xx - x0, yy - y0
    if angle != 0.0:
        ca, sa = np.cos(angle), np.sin(angle)
        dx, dy = ca * dx + sa * dy, -sa * dx + ca * dy
    return amp * np.exp(-(dx * dx / sx + dy * dy / sy) * 0.5)


def starfield(h: int, w: int, nstars: int = 50, *, seed: int = 0,
              background: float = 1000.0, noise_sigma: float = 30.0,
              shift: Tuple[float, float] = (0.0, 0.0),
              amp_range=(2000.0, 40000.0), sigma_range=(2.0, 8.0),
              stars: Optional[np.ndarray] = None):
    """One mono starfield frame (uint16, bottom-up) + the star table.

    ``stars``: optional (n, 4) table [x, y, amp, sigma] to reuse across
    frames; ``shift`` translates star positions (sub-pixel allowed).
    Returns (data (1,H,W) uint16, stars table).
    """
    rng = np.random.default_rng(seed)
    if stars is None:
        stars = np.column_stack([
            rng.uniform(10, w - 10, nstars),
            rng.uniform(10, h - 10, nstars),
            rng.uniform(*amp_range, nstars),
            rng.uniform(*sigma_range, nstars),
        ])
    img = np.full((h, w), background, dtype=np.float64)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for x0, y0, amp, sig in stars:
        x0 += shift[0]
        y0 += shift[1]
        # restrict to a window for speed
        r = int(6 * np.sqrt(sig)) + 2
        xi0, xi1 = max(0, int(x0) - r), min(w, int(x0) + r + 1)
        yi0, yi1 = max(0, int(y0) - r), min(h, int(y0) + r + 1)
        if xi0 >= xi1 or yi0 >= yi1:
            continue
        dx = xx[yi0:yi1, xi0:xi1] - x0
        dy = yy[yi0:yi1, xi0:xi1] - y0
        img[yi0:yi1, xi0:xi1] += amp * np.exp(-(dx * dx + dy * dy) / (2.0 * sig))
    if noise_sigma > 0:
        img += rng.normal(0.0, noise_sigma, size=img.shape)
    img = np.clip(np.rint(img), 0, 65535).astype(np.uint16)
    return img[None], stars


def noise_frame(h: int, w: int, *, seed: int = 0, mean: float = 1000.0,
                sigma: float = 50.0, nlayers: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.normal(mean, sigma, size=(nlayers, h, w))
    return np.clip(np.rint(img), 0, 65535).astype(np.uint16)


def gradient_frame(h: int, w: int, *, lo: float = 500.0, hi: float = 3000.0,
                   direction: str = "y", nlayers: int = 1) -> np.ndarray:
    ramp = np.linspace(lo, hi, h if direction == "y" else w)
    if direction == "y":
        img = np.broadcast_to(ramp[:, None], (h, w))
    else:
        img = np.broadcast_to(ramp[None, :], (h, w))
    return np.clip(np.rint(np.broadcast_to(img, (nlayers, h, w))), 0,
                   65535).astype(np.uint16)


def add_hot_pixels(img: np.ndarray, n: int = 20, *, seed: int = 1,
                   value: int = 60000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = img.copy()
    c, h, w = out.shape
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    out[:, ys, xs] = value
    return out


def make_sequence_frames(n: int, h: int, w: int, *, seed: int = 0,
                         shifts: Optional[np.ndarray] = None,
                         nstars: int = 30, noise_sigma: float = 20.0):
    """n starfield frames of the same sky with per-frame integer shifts
    and fresh noise. Returns (frames (n,1,H,W) uint16, stars, shifts)."""
    if shifts is None:
        rng = np.random.default_rng(seed + 999)
        shifts = rng.integers(-5, 6, size=(n, 2))
    frames = []
    stars = None
    for i in range(n):
        # frame i's content is displaced by (+sx, +sy); the aligning
        # regdata shift consumed by stacking (out(y,x) = in(y-sy, x-sx))
        # is therefore (-sx, -sy).
        data, stars = starfield(h, w, nstars, seed=seed,
                                noise_sigma=0.0, stars=stars,
                                shift=(shifts[i, 0], shifts[i, 1]))
        if noise_sigma > 0:
            rng_i = np.random.default_rng(seed + i)
            noisy = data.astype(np.float64) + rng_i.normal(0, noise_sigma, data.shape)
            data = np.clip(np.rint(noisy), 0, 65535).astype(np.uint16)
        frames.append(data)
    return np.stack(frames), stars, np.asarray(shifts, dtype=np.int32)


__all__ = ["gaussian_star", "starfield", "noise_frame", "gradient_frame",
           "add_hot_pixels", "make_sequence_frames"]
