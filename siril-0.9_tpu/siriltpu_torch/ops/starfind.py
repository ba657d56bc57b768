"""Star detection ("peaker").

Port of ``siriltpu.ops.starfind``. Reference:
src/algos/star_finder.c:103-255.

Pipeline:
1. threshold = (WORD)median + sigma·(WORD)sigma of the layer statistics
   (``Compute_threshold`` :39-57, both stats truncated to WORD first);
2. detection image = plane 2 of a 3-plane B-spline à-trous transform —
   i.e. the twice-smoothed image (:141, core/siril.c:1285);
3. 8-neighbor local maxima within (threshold, norm) in TOP-DOWN row
   order, ties broken towards the first-scanned pixel: an equal neighbor
   above or to the left disqualifies (:176-199);
4. a (2R × 2R) box around each peak from the REAL image is PSF-fitted
   without angle (:216); results pass ``is_star`` (:59-78) including the
   roundness test fwhmy/fwhmx >= roundness;
5. star position = peak + subpixel − R − 1 (:222-223); stars sorted by
   magnitude, capped at MAX_STARS = 50000 (src/core/siril.h:177).

Divergence from the reference, on purpose, as in the JAX package: peaker
fills the fit box TRANSPOSED (star_finder.c:227-235 sets z[x][y]), which
swaps the fitted subpixel offsets and sx/sy. We fit in the natural
orientation — equal for symmetric stars, strictly better positions for
elongated ones.

Star coordinates are reported in top-down (x, y) image coordinates like
the reference GUI/star lists.

The layer statistics are host NumPy (``ops.stats.statistics``); detection,
candidate selection, the box gather and the PSF fits run on ``device``.
The candidates are the JAX package's: per row the 256 highest wavelet
peaks, of those the 8192 highest, ordered by score descending and, among
equal scores, by position in scan order; here by one compaction of the
peak mask and stable sorts, where the JAX package chains two ``top_k``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from siriltpu_torch.core.frame import Rect
from siriltpu_torch.ops.psf import fit_psf_batch
from siriltpu_torch.ops.stats import STATS_BASIC, statistics
from siriltpu_torch.ops.wavelets import TO_PAVE_BSPLINE, atrous_transform
from siriltpu_torch.utils.interop import (frames_from_numpy, to_float32,
                                          u16_to_i32)
from siriltpu_torch.utils.rounding import round_to_word

Tensor = torch.Tensor

MAX_STARS = 50000
WAVELET_SCALE = 3
#: candidates kept per row of the detection image, and per frame
ROW_CANDIDATES = 256
MAX_CANDIDATES = 8192


@dataclass
class StarFinderParams:
    """starFinder tuning (src/algos/star_finder.h:6-11; GUI defaults)."""
    radius: int = 10
    sigma: float = 1.0
    roundness: float = 0.5


@dataclass
class Star:
    xpos: float
    ypos: float
    mag: float
    fwhmx: float
    fwhmy: float
    A: float
    B: float
    sx: float
    sy: float
    angle: float = 0.0
    rmse: float = 0.0
    layer: int = 0

    @property
    def pos(self):
        return (self.xpos, self.ypos)


def _wavelet_td(layer_bu: Tensor) -> Tensor:
    """The detection image of a bottom-up uint16 layer: plane 2 of the
    3-plane B-spline transform, rounded to WORD, top-down, int32."""
    tr = atrous_transform(layer_bu, WAVELET_SCALE, TO_PAVE_BSPLINE)
    return u16_to_i32(round_to_word(tr[WAVELET_SCALE - 1])).flip(0)


def _detect_peaks(wave_td: Tensor, threshold: int, norm: int, radius: int,
                  bounds) -> Tensor:
    """Local-maximum mask on the top-down int32 wavelet image.

    bounds = (x0, y0, x1, y1) detection window (top-down coords)."""
    h, w = wave_td.shape
    dev = wave_td.device
    p = wave_td
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    x0, y0, x1, y1 = bounds
    inwin = ((yy >= y0 + radius) & (yy < y1 - radius) &
             (xx >= x0 + radius) & (xx < x1 - radius))
    ok = (p > threshold) & (p < norm) & inwin

    pad = torch.nn.functional.pad(p, (1, 1, 1, 1),
                                  value=torch.iinfo(torch.int32).max)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = pad[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            # tie rule (star_finder.c:189-196): an equal neighbor with
            # (dx<=0 and dy<=0) or (dx>0 and dy<0) disqualifies
            if (dx <= 0 and dy <= 0) or (dx > 0 and dy < 0):
                ok = ok & (nv < p)
            else:
                ok = ok & (nv <= p)
    return ok


def _select_candidates(wave_td: Tensor, mask: Tensor, cap: int):
    """Top-down (ys, xs) of the peaks to fit, brightest first: of every
    row the ROW_CANDIDATES highest wavelet values, of those the ``cap``
    highest; equal values in scan order (rows, then columns). One host
    sync (the compaction)."""
    ys, xs = torch.nonzero(mask, as_tuple=True)       # in scan order
    order = torch.sort(wave_td[ys, xs], descending=True, stable=True).indices
    ys, xs = ys[order], xs[order]
    # rank of every candidate within its row, by score: a stable sort on
    # the row leaves each row's candidates in score order
    by_row = torch.sort(ys, stable=True)
    first = torch.searchsorted(by_row.values, by_row.values)
    rank = torch.empty_like(ys)
    rank[by_row.indices] = torch.arange(ys.numel(), device=ys.device) - first
    keep = rank < ROW_CANDIDATES
    return ys[keep][:cap], xs[keep][:cap]


def _gather_boxes(real_td: Tensor, ys: Tensor, xs: Tensor, radius: int) -> Tensor:
    """(n, 2R, 2R) float32 boxes of the top-down uint16 image at the peak
    coords."""
    span = torch.arange(-radius, radius, device=ys.device)
    rows = (ys[:, None] + span[None, :])[:, :, None]
    cols = (xs[:, None] + span[None, :])[:, None, :]
    return to_float32(real_td.view(torch.int16)[rows, cols].view(torch.uint16))


def _find_and_fit(layer_dev: Tensor, threshold: int, norm: int, bg: float,
                  radius: int, bounds, cap: int):
    """Detect, select, gather and fit on the device of ``layer_dev``, a
    bottom-up (H, W) uint16 layer. Returns NumPy (10, n) fit fields (A, B,
    x0, y0, sx, sy, fwhmx, fwhmy, mag, ok) and the peaks' (ys, xs)."""
    wave_td = _wavelet_td(layer_dev)
    mask = _detect_peaks(wave_td, threshold, norm, radius, bounds)
    ys, xs = _select_candidates(wave_td, mask, cap)
    n = int(ys.numel())
    if n == 0:
        return np.zeros((10, 0), np.float32), np.zeros(0, np.int64), \
            np.zeros(0, np.int64)
    real_td = layer_dev.view(torch.int16).flip(0).view(torch.uint16)
    boxes = _gather_boxes(real_td, ys, xs, radius)
    bgs = torch.full((n,), bg, dtype=torch.float32, device=layer_dev.device)
    fit = fit_psf_batch(boxes, bgs, fit_angle=False, norm=float(norm))
    # all fit fields and the coordinates cross to the host in one copy
    packed = torch.stack([
        fit.A, fit.B, fit.x0, fit.y0, fit.sx, fit.sy, fit.fwhmx, fit.fwhmy,
        fit.mag, fit.ok.to(torch.float32), ys.to(torch.float32),
        xs.to(torch.float32)]).cpu().numpy()
    return packed[:10], packed[10].astype(np.int64), packed[11].astype(np.int64)


def _threshold(layer_bu: np.ndarray, sf: StarFinderParams):
    """(threshold, norm, background) from the host statistics of a layer,
    or None for a layer without good pixels (Compute_threshold,
    star_finder.c:39-57)."""
    st = statistics(layer_bu, option=STATS_BASIC, nullcheck=True,
                    skip_noise=True)
    if st is None:
        return None
    threshold = int(np.uint16(st.median) + sf.sigma * np.uint16(st.sigma))
    return threshold, int(st.norm_value), st.median


def peaker(layer_bu: np.ndarray, *, device,
           params: Optional[StarFinderParams] = None,
           area: Optional[Rect] = None, layer_index: int = 0,
           norm: Optional[int] = None, return_device: bool = False,
           layer_dev: Optional[Tensor] = None):
    """Find stars on a bottom-up uint16 layer, on ``device``; returns stars
    sorted by magnitude (brightest first), positions in top-down coords.

    With ``return_device`` the result is ``(stars, layer_dev)`` where
    ``layer_dev`` is the copy of the layer on the device, which
    registration reuses for the warp instead of a second copy. Callers
    that already hold that copy pass it as ``layer_dev``."""
    sf = params or StarFinderParams()
    layer_bu = np.asarray(layer_bu)
    h, w = layer_bu.shape
    found = _threshold(layer_bu, sf)
    if found is None:
        return ([], None) if return_device else []
    threshold, st_norm, bg = found
    if norm is None:
        norm = st_norm
    if layer_dev is None:
        layer_dev = frames_from_numpy(layer_bu, device)
    bounds = ((area.x, area.y, area.x + area.w, area.y + area.h)
              if area is not None else (0, 0, w, h))
    packed, ys, xs = _find_and_fit(layer_dev, threshold, norm, bg, sf.radius,
                                   bounds, min(MAX_CANDIDATES, MAX_STARS))
    stars = _build_stars(packed, ys, xs, sf, layer_index)
    return (stars, layer_dev) if return_device else stars


def _build_stars(packed: np.ndarray, ys, xs, sf: StarFinderParams,
                 layer_index: int) -> List[Star]:
    """is_star filtering (star_finder.c:59-78) + Star construction from a
    (10, N) packed fit-field array; sorted by magnitude."""
    A, B, x0, y0, sx, sy, fwx, fwy, mag, okv = packed
    okv = okv != 0.0
    stars: List[Star] = []
    for k in range(len(ys)):
        if not okv[k]:
            continue
        if not (np.isfinite(fwx[k]) and np.isfinite(fwy[k])):
            continue
        if not (np.isfinite(x0[k]) and np.isfinite(y0[k]) and
                np.isfinite(mag[k])):
            continue
        if x0[k] <= 0.0 or y0[k] <= 0.0:
            continue
        if A[k] < 0.01:
            continue
        if sx[k] > 200 or sy[k] > 200:
            continue
        if fwx[k] <= 0.0 or fwy[k] <= 0.0:
            continue
        if (fwy[k] / fwx[k]) < sf.roundness:
            continue
        stars.append(Star(
            xpos=float(xs[k] + x0[k] - sf.radius - 1),
            ypos=float(ys[k] + y0[k] - sf.radius - 1),
            mag=float(mag[k]), fwhmx=float(fwx[k]), fwhmy=float(fwy[k]),
            A=float(A[k]), B=float(B[k]), sx=float(sx[k]), sy=float(sy[k]),
            layer=layer_index))
    stars.sort(key=lambda s: s.mag)
    return stars


def peaker_batch(layers_bu: np.ndarray, *, device,
                 params: Optional[StarFinderParams] = None,
                 layer_index: int = 0, nmax: int = 1024,
                 mesh=None, return_device: bool = False):
    """Star-find a BATCH of bottom-up uint16 layers (F, H, W) on
    ``device``; returns one sorted star list per frame.

    Same per-star math as :func:`peaker` (the frames go through the same
    device code one after the other, as the JAX package's ``lax.map``),
    with one difference: candidates are capped at the ``nmax`` BRIGHTEST
    wavelet peaks per frame. With ``mesh`` (a Mesh with a ``frames``
    axis, ``parallel.mesh``) the batch is sharded so each entry's device
    star-finds its own frames, as the reference's OpenMP-over-frames
    registration (registration.c:276-279); ``device`` is then unused and
    no device copy is returned. With ``return_device`` the result is
    ``(lists, layers_dev)``, the frames' copy on the device."""
    sf = params or StarFinderParams()
    layers_bu = np.asarray(layers_bu)
    f, h, w = layers_bu.shape
    # the host statistics of every frame first; a frame without a good
    # pixel (or the pad of a mesh's last shard) finds no star
    thresholds = np.zeros(f, np.int64)
    norms = np.zeros(f, np.int64)
    bgs = np.zeros(f, np.float64)
    good = np.zeros(f, bool)
    for i in range(f):
        found = _threshold(layers_bu[i], sf)
        if found is not None:
            thresholds[i], norms[i], bgs[i] = found
            good[i] = True

    def shard(layers, thr, nrm, bg, ok):
        out: List[List[Star]] = []
        for i in range(layers.shape[0]):
            if not bool(ok[i]):
                out.append([])
                continue
            packed, ys, xs = _find_and_fit(layers[i], int(thr[i]), int(nrm[i]),
                                           float(bg[i]), sf.radius, (0, 0, w, h),
                                           min(MAX_CANDIDATES, nmax))
            out.append(_build_stars(packed, ys, xs, sf, layer_index))
        return out

    if mesh is not None:
        from siriltpu_torch.parallel.mesh import run_frames_sharded

        result = run_frames_sharded(shard, mesh, layers_bu, thresholds, norms,
                                    bgs, good)
        return (result, None) if return_device else result
    layers_dev = frames_from_numpy(layers_bu, device)
    result = shard(layers_dev, thresholds, norms, bgs, good)
    if return_device:
        return result, layers_dev
    return result


__all__ = ["peaker", "peaker_batch", "Star", "StarFinderParams", "MAX_STARS"]
