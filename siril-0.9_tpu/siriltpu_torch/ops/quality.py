"""Planetary image quality estimate (PIPP-derived).

Port of ``siriltpu.ops.quality``. Reference: src/algos/quality.c
(``QualityEstimate`` :46-218, ``SubSample`` :223-233, ``Gradient``
:236-330, ``_smooth_image_16`` :332-349) with constants from quality.h
(QSUBSAMPLE 3..5, QMARGIN 0.1, THRESHOLD 40, MAXP 6).

Pipeline per subsample factor s: integer box-mean subsample → histogram
stretch to max≈60000 → 3×3 integer smooth → gradient energy over a 3×3
dilated mask of pixels ≥ 40<<8 → q = energy/pixels/10.

Two reference quirks are reproduced exactly:

1. The MAXP "average of brightest" insert loop is buggy
   (quality.c:129-133 writes ``maxp[j] = maxp[j-1]`` then immediately
   ``maxp[j] = v``), which degenerates the whole maxp machinery to a
   *running maximum of middle-row samples below 65530*. So the stretch
   factor is just ``60000 / max(middle-row samples < 65530)``.
2. The per-subsample weight for QUALTYPE_NORMAL is the C integer division
   ``(3*3)/(s*s)`` (quality.c:193-196) which is 1 for s=3 and **0** for
   s=4,5 — only the s=3 scale contributes. QUALTYPE_NINOX sums all scales
   unweighted.

Quality for NORMAL = sqrt(q_s3). If no pixel exceeds the threshold the
gradient returns -1 and the sqrt is NaN, as in the reference.

The float64 NumPy implementation (exact) is the anchor; the batched torch
version runs the s=3 pipeline over a frame batch on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from siriltpu_torch.utils.interop import u16_to_i32

QSUBSAMPLE_MIN = 3
QSUBSAMPLE_MAX = 5
QMARGIN = 0.1
THRESHOLD = 40 << 8
MAXP_CAP = 65530

QUALTYPE_NORMAL = 0
QUALTYPE_NINOX = 1

# frames per batch are capped so that a batch holds at most this many
# pixels: the per-frame working set (int32 copies, masks) is ~80 MB at 4K
_BATCH_PIXELS = 1 << 27


# ----------------------------------------------------------------- NumPy path

def _subsample_np(layer: np.ndarray, s: int):
    """Integer box-mean subsample with region (w-1, h-1) like the reference."""
    h, w = layer.shape
    region_w, region_h = w - 1, h - 1
    xs, ys = region_w // s, region_h // s
    if xs < 2 or ys < 2:
        return None
    a = layer[: ys * s, : xs * s].astype(np.int64)
    box = a.reshape(ys, s, xs, s).sum(axis=(1, 3)) // (s * s)
    return box  # (ys, xs) int


def _stretch_np(buf: np.ndarray) -> np.ndarray:
    ys = buf.shape[0]
    mid = buf[1 : ys - 1]  # middle rows track the max (quality.c:101-137)
    cand = mid[(mid > 0) & (mid < MAXP_CAP)]
    mx = int(cand.max()) if cand.size else 0
    if mx > 0:
        mult = 60000.0 / mx
        v = (buf.astype(np.float64) * mult).astype(np.uint64)  # C truncation
        return np.minimum(v, 65535).astype(np.int64)
    return buf.astype(np.int64)


def _smooth_np(buf: np.ndarray) -> np.ndarray:
    """3x3 integer-mean smooth, borders zero (quality.c:332-349)."""
    h, w = buf.shape
    out = np.zeros_like(buf)
    if h < 3 or w < 3:
        return out
    s = (buf[:-2, :-2] + buf[:-2, 1:-1] + buf[:-2, 2:] +
         buf[1:-1, :-2] + buf[1:-1, 1:-1] + buf[1:-1, 2:] +
         buf[2:, :-2] + buf[2:, 1:-1] + buf[2:, 2:])
    out[1:-1, 1:-1] = s // 9
    return out


def _gradient_np(buf: np.ndarray, qtype: int) -> float:
    h, w = buf.shape
    yb = int(h * QMARGIN) + 1
    xb = int(w * QMARGIN) + 1
    if yb >= h - yb or xb >= w - xb:
        return -1.0
    interior = np.zeros((h, w), dtype=bool)
    interior[yb : h - yb, xb : w - xb] = True
    sig = (buf >= THRESHOLD) & interior
    npx = int(sig.sum())
    if not npx:
        return -1.0
    avg = float(buf[sig].sum()) / npx
    # 3x3 dilation of sig
    m = np.zeros((h + 2, w + 2), dtype=bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            m[dy : dy + h, dx : dx + w] |= sig
    mask = m[1 : 1 + h, 1 : 1 + w] & interior
    b = buf.astype(np.float64)
    d1 = b - np.roll(b, -1, axis=1)   # buf[o] - buf[o+1]
    d2 = b - np.roll(b, -1, axis=0)   # buf[o] - buf[o+width]
    if qtype == QUALTYPE_NINOX:
        val = (np.abs(d1) + np.abs(d2))[mask].sum()
    else:
        val = (d1 * d1 + d2 * d2)[mask].sum()
    pixels = int(mask.sum())
    val /= pixels
    if qtype == QUALTYPE_NINOX:
        return float(val * 50.0 / avg)
    return float(val / 10.0)


def quality_estimate(layer: np.ndarray, qtype: int = QUALTYPE_NORMAL) -> float:
    """Exact reference QualityEstimate on one uint16 layer."""
    layer = np.asarray(layer)
    if layer.ndim == 3:
        layer = layer[0]
    h, w = layer.shape
    dval = 0.0
    s = QSUBSAMPLE_MIN
    while s <= QSUBSAMPLE_MAX:
        sub = _subsample_np(layer, s)
        if sub is None:
            break
        ys, xs = sub.shape
        stretched = _stretch_np(sub)
        smoothed = _smooth_np(stretched)
        q = _gradient_np(smoothed, qtype)
        if qtype == QUALTYPE_NINOX:
            dval += q
        else:
            dval += q * ((QSUBSAMPLE_MIN * QSUBSAMPLE_MIN) // (s * s))  # int div!
        # skip factors with identical sample grids (quality.c:200-204)
        while True:
            s += 1
            if not (w // s == xs and h // s == ys):
                break
    with np.errstate(invalid="ignore"):
        return float(np.sqrt(dval))


# ------------------------------------------------------------------ torch path

def _quality_s3(layers: torch.Tensor) -> torch.Tensor:
    """The s=3 quality pipeline (the only scale with nonzero NORMAL weight)
    for (F, h, w) uint16 layers; returns (F,) q (pre-sqrt), float32."""
    _, h, w = layers.shape
    s = 3
    xs, ys = (w - 1) // s, (h - 1) // s
    a = u16_to_i32(layers[:, : ys * s, : xs * s])
    sub = sum(a[:, dy::s, dx::s] for dy in range(s) for dx in range(s)) // (s * s)
    mid = sub[:, 1 : ys - 1]
    mx = torch.where((mid > 0) & (mid < MAXP_CAP), mid, 0).amax(dim=(1, 2))
    mxf = mx.to(torch.float32)
    # a true f32 division, as in JAX (``60000.0 / t`` is reciprocal * 60000)
    mult = torch.where(mx > 0, torch.full_like(mxf, 60000.0) / mxf, 1.0)
    stretched = torch.where(
        (mx > 0)[:, None, None],
        torch.clamp(torch.floor(sub.to(torch.float32) * mult[:, None, None]),
                    max=65535.0).to(torch.int32),
        sub)
    # 3x3 smooth; the reference zeroes the output borders (quality.c:334)
    p = F.pad(stretched, (1, 1, 1, 1))
    sm = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:] +
          p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:] +
          p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) // 9
    sm = F.pad(sm[:, 1:-1, 1:-1], (1, 1, 1, 1))
    # gradient
    yb = int(ys * QMARGIN) + 1
    xb = int(xs * QMARGIN) + 1
    yy = torch.arange(ys, device=layers.device)[:, None]
    xx = torch.arange(xs, device=layers.device)[None, :]
    interior = (yy >= yb) & (yy < ys - yb) & (xx >= xb) & (xx < xs - xb)
    sig = (sm >= THRESHOLD) & interior
    npx = sig.sum(dim=(1, 2))
    sp = F.pad(sig.to(torch.uint8), (1, 1, 1, 1))
    dil = torch.zeros_like(sig)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            dil |= sp[:, dy : dy + ys, dx : dx + xs] != 0
    mask = dil & interior
    b = sm.to(torch.float32)
    d1 = b - torch.roll(b, -1, dims=2)
    d2 = b - torch.roll(b, -1, dims=1)
    val = torch.where(mask, d1 * d1 + d2 * d2, 0.0).sum(dim=(1, 2))
    pixels = mask.sum(dim=(1, 2))
    return torch.where(
        npx > 0, val / torch.clamp(pixels, min=1).to(torch.float32) / 10.0, -1.0)


def quality_estimate_batch(layers: torch.Tensor) -> torch.Tensor:
    """Batched QUALTYPE_NORMAL quality over (F, H, W) uint16 frames on their
    device; returns (F,) float32 sqrt(q_s3). Frames go in batches of at
    most 2^27 pixels to bound the working set."""
    f, h, w = layers.shape
    step = max(1, _BATCH_PIXELS // (h * w))
    qs = [_quality_s3(layers[i : i + step]) for i in range(0, f, step)]
    return torch.sqrt(torch.cat(qs))


def find_centre(layer: np.ndarray, eightbit: bool = False):
    """Centre of brightness (quality.c _FindCentre_Barycentre:361-426,
    FindCentre:437-444): barycentre of pixels whose value AND all four
    4-neighbors reach THRESHOLD (quality.h:29, x256 for 16-bit data).
    Scan window x in [2, rx-3], y in [1, ry-2] (edge guard). Returns
    (x_avg, y_avg) with the +0.5 offsets and the bottom-up y flip of
    the C code, or None when fewer than MinPixels=50 qualify.
    ``layer`` is a bottom-up (H, W) plane like fit->data."""
    a = np.asarray(layer)
    h, w = a.shape
    thr = 40 if eightbit else 40 * 256
    x1, y1 = 2, 1
    x2, y2 = min(w - 3, w - 2), min(h - 1, h - 2)
    if x2 < x1 or y2 < y1:
        return None
    win = a[y1 : y2 + 1, x1 : x2 + 1]
    ok = ((win >= thr)
          & (a[y1 : y2 + 1, x1 - 1 : x2] >= thr)
          & (a[y1 : y2 + 1, x1 + 1 : x2 + 2] >= thr)
          & (a[y1 - 1 : y2, x1 : x2 + 1] >= thr)
          & (a[y1 + 1 : y2 + 2, x1 : x2 + 1] >= thr))
    count = int(ok.sum())
    if count < 50:  # MinPixels, quality.c:359 (count==0 folds in)
        return None
    ys, xs = np.nonzero(ok)
    x_avg = (xs + x1).sum() / count + 0.5
    y_avg = (ys + y1).sum() / count + 0.5
    return float(x_avg), float(h - y_avg)


def normalize_quality(qualities: np.ndarray) -> np.ndarray:
    """normalizeQualityData (registration.c:163-176): (q - min)/(max - min)."""
    q = np.asarray(qualities, dtype=np.float64)
    qmin, qmax = np.nanmin(q), np.nanmax(q)
    if qmax == qmin:
        return np.zeros_like(q)
    return (q - qmin) / (qmax - qmin)


__all__ = ["quality_estimate", "quality_estimate_batch", "normalize_quality",
           "find_centre",
           "QUALTYPE_NORMAL", "QUALTYPE_NINOX"]
