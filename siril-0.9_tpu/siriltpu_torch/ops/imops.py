"""Pixel arithmetic and geometric transforms on Frames.

Port of ``siriltpu.ops.imops``. What the JAX package does in host NumPy
is copied (the arithmetic, crop and flips, entropy, the LUTs, fill, shift,
the median filter, banding reduction, ``sub_background_layer``); what it
does in ``jnp`` runs in torch on ``device``: the Gaussian blur of ``ddp``
and ``unsharp`` (``ops/interp.py:sep_filter``), the wavelet plane of
``background_noise`` (``ops/wavelets.py``), the two matmuls of ``resize``
(in full float32, never TF32) and the sampler of ``rotate``, which is the
port's gather warp (``ops/warp.py``; the JAX package's tiled sampler is
not ported). ``lrgb`` is the host NumPy ``compose`` of
``pipelines/compositing.py``.

Reference: src/core/siril.c:65-1862 — soper (:112), imoper (:150),
fdiv (:252), ndiv (:278), addmax/addmin (:229), crop, mirrorx/y,
fits_rotate_pi (:770), entropy (:596), loglut (:636), contrast (:618),
ddp (:1792), visu (:665), fill (:696), sub_background (:192), and
cvUnsharpFilter / cvResizeGaussian / cvRotateImage glue
(src/opencv/opencv.cpp:80-205).

Semantics frozen:
- soper: double arithmetic + round_to_WORD;
- imoper: C INTEGER arithmetic between WORD operands (division is
  integer division!) then round_to_WORD (siril.c:150-190);
- fdiv: zero divisor pixels are set to 1 IN THE DIVISOR (mutation,
  siril.c:256-258), result coef*a/b in double, overflow flag;
- sub_background works in [0,1] doubles and re-offsets by |min|
  (siril.c:192-240).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from siriltpu_torch.utils.interop import (frames_from_numpy, i32_to_u16, to_float32,
                                         u16_to_numpy)
from siriltpu_torch.utils.rounding import np_round_to_word

OPER_ADD = "add"
OPER_SUB = "sub"
OPER_MUL = "mul"
OPER_DIV = "div"


def soper(data: np.ndarray, scalar: float, oper: str) -> np.ndarray:
    """a = round_to_WORD(a (op) scalar) in double (siril.c:112-146)."""
    x = data.astype(np.float64)
    if oper == OPER_ADD:
        r = x + scalar
    elif oper == OPER_SUB:
        r = x - scalar
    elif oper == OPER_MUL:
        r = x * scalar
    elif oper == OPER_DIV:
        r = x / scalar
    else:
        raise ValueError(oper)
    return np_round_to_word(r)


def imoper(a: np.ndarray, b: np.ndarray, oper: str) -> np.ndarray:
    """a = round_to_WORD(a (op) b) with C INT arithmetic (siril.c:150-190);
    note DIV is integer division in the reference."""
    if a.shape != b.shape:
        raise ValueError(f"imoper: images don't have the same size "
                         f"{a.shape} vs {b.shape}")
    ai = a.astype(np.int64)
    bi = b.astype(np.int64)
    if oper == OPER_ADD:
        r = ai + bi
    elif oper == OPER_SUB:
        r = ai - bi
    elif oper == OPER_MUL:
        # The C multiplies in 32-bit signed int, so products above
        # INT_MAX are UB; gcc -O2's vectorized round_to_WORD resolves
        # them to (prod mod 65536) + 1 (verified exhaustively over the
        # boundary region against the compiled reference loop in
        # test_c_goldens/parity_harness). Products in (65535, INT_MAX]
        # clamp to 65535 as written.
        prod = ai * bi
        r = np.where(prod > 0x7FFFFFFF, (prod % 65536 + 1) & 0xFFFF, prod)
    elif oper == OPER_DIV:
        r = np.where(bi == 0, 0, ai // np.maximum(bi, 1))  # C int division
    else:
        raise ValueError(oper)
    return np.clip(r, 0, 65535).astype(np.uint16)


def fdiv(a: np.ndarray, b: np.ndarray, coef: float) -> Tuple[np.ndarray, int]:
    """a = round_to_WORD(coef * a / b); divisor zeros become 1
    (siril.c:252-276). Returns (result, overflow_flag)."""
    if a.shape != b.shape:
        raise ValueError("fdiv: wrong size or channel count")
    bb = np.where(b == 0, 1, b).astype(np.float64)
    temp = coef * (a.astype(np.float64) / bb)
    overflow = int((temp > 65535.0).any())
    return np_round_to_word(temp), overflow


def ndiv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Normalized division keeping each layer's original max (siril.c:278)."""
    out = np.empty_like(a)
    for c in range(a.shape[0]):
        div = np.where(b[c] == 0, a[c].astype(np.float64),
                       a[c].astype(np.float64) / b[c].astype(np.float64))
        mx = div.max()
        norm = mx / max(float(a[c].max()), 1.0)
        out[c] = np_round_to_word(div / norm if norm != 0 else div)
    return out


def addmax(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-pixel max (siril.c:229-250)."""
    return np.maximum(a, b)


def crop(data: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Crop with a TOP-DOWN selection on bottom-up data."""
    ry = data.shape[-2]
    y0 = ry - y - h
    return np.ascontiguousarray(data[..., y0 : y0 + h, x : x + w])


def mirrorx(data: np.ndarray) -> np.ndarray:
    """Vertical flip (mirror along x axis)."""
    return np.ascontiguousarray(data[..., ::-1, :])


def mirrory(data: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(data[..., :, ::-1])


def rotate_pi(data: np.ndarray) -> np.ndarray:
    """180-degree rotation (fits_rotate_pi, siril.c:770-811)."""
    return np.ascontiguousarray(data[..., ::-1, ::-1])


def entropy(layer: np.ndarray, rect=None, stats=None) -> float:
    """Entropy as the reference computes it (siril.c:570-594, verified
    against the compiled C in test_c_goldens):

    - the histogram is a GSL histogram of ``norm + 1`` uniform bins over
      [0, norm] (norm = 255 for byte-range images, else 65535), so
      value == norm pixels fall off the open upper edge and are DROPPED;
    - ``n`` is the FULL image pixel count even when a selection ``rect``
      limits the histogram (top-down rect on bottom-up data);
    - each bin contributes (p/n)·ln(n/p) only when ``threshold < p <
      nbins`` — p is the bin COUNT, yet the optional ``stats`` threshold
      is median + sigma, a pixel-VALUE scale (reference bug, kept)."""
    norm = 255 if int(layer.max()) <= 255 else 65535
    threshold = 0.0
    if stats is not None and stats.median >= 0.0 and stats.sigma >= 0.0:
        threshold = stats.median + 1 * stats.sigma
    if rect is None:
        sel = layer
    else:
        ry = layer.shape[-2]
        y0 = ry - rect.y - rect.h
        sel = layer[y0 : y0 + rect.h, rect.x : rect.x + rect.w]
    counts = np.bincount(sel.reshape(-1), minlength=norm + 1)[: norm + 1]
    counts = counts.astype(np.float64)
    counts[norm] = 0.0        # == norm falls off the GSL upper edge
    n = float(layer.shape[-1] * layer.shape[-2])
    size = float(norm + 1)
    p = counts[(counts > threshold) & (counts < size)]
    return float(((p / n) * np.log(n / p)).sum())


def loglut(data: np.ndarray, inverted: bool = False) -> np.ndarray:
    """Log LUT (siril.c:596-616, verified against the compiled C):
    LOG: WORD = (WORD)(k·ln(v+1)) with k = 65535/ln(65535) — a
    TRUNCATION cast, not round_to_WORD. EXP: WORD = (WORD)exp((v+1)/k),
    whose result can slightly exceed 65535 near the top of the range;
    the compiled double→WORD cast goes through int32 truncation and
    keeps the low 16 bits (x86-64 cvttsd2si), reproduced here."""
    k = 65535.0 / np.log(65535.0)
    x = data.astype(np.float64)
    if not inverted:   # LOG direction
        out = k * np.log(x + 1.0)
    else:              # EXP direction
        out = np.exp((x + 1.0) / k)
    return (out.astype(np.int64) & 0xFFFF).astype(np.uint16)


def contrast(layer: np.ndarray, mean: float) -> float:
    """Contrast metric (siril.c:618-634): mean squared deviation of the
    FULL layer from ``mean`` — the reference takes the mean from
    statistics over com.selection but always sums the whole image."""
    buf = layer.astype(np.float64)
    return float(((buf - mean) ** 2).sum() / buf.size)


def _blur(layer: np.ndarray, k: np.ndarray, device) -> np.ndarray:
    """One float32 layer blurred by the separable kernel ``k`` on
    ``device`` (the JAX package's jnp ``sep_filter``), back on the host."""
    from siriltpu_torch.ops.interp import sep_filter

    taps = [float(t) for t in k]
    x = torch.from_numpy(np.ascontiguousarray(layer, dtype=np.float32)).to(device)
    return sep_filter(x, taps, taps).cpu().numpy()


def ddp(data: np.ndarray, level: float, coef: float, sigma: float, *,
        device) -> np.ndarray:
    """Digital development processing (siril.c ddp command path):
    out = coef * a / (blur(a) + level), unsharp-like tone mapping; the
    blur on ``device``."""
    out = np.empty_like(data)
    for c in range(data.shape[0]):
        x = data[c].astype(np.float32)
        blurred = _blur(x, _gauss_kernel(sigma), device) if sigma > 0 else x
        out[c] = np_round_to_word(coef * x.astype(np.float64) /
                                  (blurred.astype(np.float64) + level))
    return out


def _gauss_kernel(sigma: float) -> np.ndarray:
    """cv::GaussianBlur's automatic kernel for 16-bit images:
    ksize = cvRound(sigma·4·2 + 1) | 1 (createGaussianFilter's
    non-8U rule), sampled Gaussian normalized — anchored against the
    real OpenCV via the unsharp records of c_cvgeom.bin."""
    ksize = int(np.rint(sigma * 8 + 1)) | 1
    r = max(1, (ksize - 1) // 2)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def unsharp(data: np.ndarray, sigma: float, amount: float, *,
            device) -> np.ndarray:
    """cvUnsharpFilter (opencv.cpp:311-335): out = a*(1+amount) -
    blur*amount; amount 0 -> pure Gaussian blur. The blur on ``device``."""
    out = np.empty_like(data)
    k = _gauss_kernel(sigma)
    for c in range(data.shape[0]):
        x = data[c].astype(np.float32)
        blurred = _blur(x, k, device).astype(np.float64)
        if amount == 0.0:
            r = blurred
        else:
            r = x.astype(np.float64) * (1.0 + amount) - blurred * amount
        out[c] = np_round_to_word(r)
    return out


def _np_keys_weights(t: float, A: float = -0.75):
    """Keys cubic weights for taps at distances 1+t, t, 1-t, 2-t."""
    ws = []
    for d in (1 + t, t, 1 - t, 2 - t):
        d = abs(d)
        if d <= 1:
            ws.append(((A + 2) * d - (A + 3)) * d * d + 1)
        elif d < 2:
            ws.append(((A * d - 5 * A) * d + 8 * A) * d - 4 * A)
        else:
            ws.append(0.0)
    return ws


def _np_lanczos4_weights(t: float):
    """Normalized Lanczos-4 (sinc(d)·sinc(d/4)), taps d = t+3-i."""
    if t < 1e-7:
        return [0, 0, 0, 1, 0, 0, 0, 0]
    ws = []
    for i in range(8):
        x = (t + 3 - i) * np.pi
        ws.append(np.sin(x) / x * np.sin(x * 0.25) / (x * 0.25))
    tot = sum(ws)
    return [w / tot for w in ws]


def _resize_weights(src: int, dst: int, interp: int,
                    both_shrink: bool) -> np.ndarray:
    """Per-axis (dst, src) resampling weight matrix reproducing
    cv::resize's exact conventions (anchored ≤1 LSB against the real
    OpenCV 4.6, tests/goldens/c_cvgeom.bin):

    - taps at fx = (dx+0.5)·scale − 0.5, CLAMPED to the image (border
      replication — unlike warps, resize never reads a constant
      border);
    - NEAREST picks floor(dx·scale) (not round!);
    - AREA with both axes shrinking = true fractional-coverage box
      average; otherwise cv's 2-tap emulation
      fx = (dx+1) − (sx+1)·dst/src (degenerates to floor-nearest on
      integer zoom);
    - CUBIC is Keys A = −0.75, LANCZOS4 the normalized windowed sinc.
    """
    scale = src / dst
    inv = dst / src
    W = np.zeros((dst, src), np.float64)
    if interp == 0:
        for dx in range(dst):
            W[dx, min(int(np.floor(dx * scale)), src - 1)] = 1.0
        return W
    if interp == 3:
        if both_shrink:
            for i in range(dst):
                a, b = i * scale, (i + 1) * scale
                for k in range(int(np.floor(a)), min(int(np.ceil(b)), src)):
                    W[i, k] = min(b, k + 1.0) - max(a, float(k))
                W[i] /= W[i].sum()
            return W
        for dx in range(dst):
            sx = int(np.floor(dx * scale))
            fx = (dx + 1) - (sx + 1) * inv
            fx = 0.0 if fx <= 0 else fx - np.floor(fx)
            W[dx, min(max(sx, 0), src - 1)] += 1 - fx
            W[dx, min(max(sx + 1, 0), src - 1)] += fx
        return W
    for dx in range(dst):
        fx = (dx + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        t = fx - sx
        if interp == 1:
            offs, ws = (0, 1), (1 - t, t)
        elif interp == 2:
            offs, ws = (-1, 0, 1, 2), _np_keys_weights(t)
        elif interp == 4:
            offs, ws = range(-3, 5), _np_lanczos4_weights(t)
        else:
            raise ValueError(f"unknown interpolation {interp}")
        for o, wgt in zip(offs, ws):
            W[dx, min(max(sx + o, 0), src - 1)] += wgt
    return W


@contextlib.contextmanager
def _ieee_float32_matmul():
    """CUDA float32 matmuls in full IEEE float32 (no TF32 passes, which
    would shred 16-bit pixel values) whatever the process-wide setting;
    the setting is restored on exit."""
    m = torch.backends.cuda.matmul
    old = m.fp32_precision
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = old


def _word(x: torch.Tensor) -> np.ndarray:
    """float32 tensor -> uint16 on the host as np.clip(np.rint(x)): round
    half to even, clamped as floats before the cast."""
    return u16_to_numpy(i32_to_u16(torch.clamp(torch.round(x), 0, 65535)))


def resize(data: np.ndarray, new_w: int, new_h: int,
           interpolation: int = 1, *, device) -> np.ndarray:
    """cvResizeGaussian (opencv.cpp:80-130): cv::resize with the
    interpolation VALUE the reference passes verbatim to OpenCV —
    0 nearest, 1 linear, 2 cubic, 3 area, 4 lanczos4 (the runtime
    meaning of the values; siril.h's enum names for 2/3 are swapped
    relative to OpenCV's — PARITY.md "interpolation enum").

    Separable resampling as two float32 matmuls Wy · img · Wxᵀ per
    channel on ``device``, weights built on the host per geometry."""
    c, h, w = data.shape
    both_shrink = new_w <= w and new_h <= h
    Wy = torch.from_numpy(_resize_weights(h, new_h, interpolation, both_shrink)
                          .astype(np.float32)).to(device)
    Wx = torch.from_numpy(_resize_weights(w, new_w, interpolation, both_shrink)
                          .astype(np.float32)).to(device)
    imgs = frames_from_numpy(np.asarray(data, dtype=np.uint16), device)
    out = np.empty((c, new_h, new_w), dtype=np.uint16)
    with _ieee_float32_matmul():
        for ch in range(c):
            out[ch] = _word(torch.matmul(torch.matmul(Wy, to_float32(imgs[ch])), Wx.T))
    return out


def rotate(data: np.ndarray, angle_deg: float, *, crop_to_fit: bool = True,
           interpolation: int = 1, device) -> np.ndarray:
    """cvRotateImage (opencv.cpp:132-205): rotation about the image
    center; when not cropping the output grows to the bounding box. The
    port's gather warp on ``device`` at every angle."""
    from siriltpu_torch.ops.warp import warp_perspective

    c, h, w = data.shape
    a = np.radians(angle_deg)
    ca, sa = np.cos(a), np.sin(a)
    if crop_to_fit:
        oh, ow = h, w
    else:
        ow = int(np.ceil(abs(w * ca) + abs(h * sa)))
        oh = int(np.ceil(abs(w * sa) + abs(h * ca)))
    cx_in, cy_in = (w - 1) / 2.0, (h - 1) / 2.0
    cx_out, cy_out = (ow - 1) / 2.0, (oh - 1) / 2.0
    # inverse map: src = R^-1 (dst - c_out) + c_in
    Hinv = np.array([[ca, sa, cx_in - ca * cx_out - sa * cy_out],
                     [-sa, ca, cy_in + sa * cx_out - ca * cy_out],
                     [0, 0, 1.0]])
    Hinv_dev = torch.from_numpy(Hinv.astype(np.float32)).to(device)
    imgs = frames_from_numpy(np.asarray(data, dtype=np.uint16), device)
    out = np.empty((c, oh, ow), dtype=np.uint16)
    for ch in range(c):
        out[ch] = _word(warp_perspective(imgs[ch], Hinv_dev, (oh, ow), interpolation))
    return out


def sub_background_layer(image: np.ndarray, background: np.ndarray
                         ) -> np.ndarray:
    """sub_background (siril.c:192-240): subtract in [0,1] doubles, then
    add |min| so the result is non-negative. In-place arithmetic: large
    fresh allocations are disproportionately slow on this host."""
    d = image.astype(np.float64)
    d /= 65535.0
    b = background.astype(np.float64)
    b /= 65535.0
    d -= b
    d += abs(d.min())
    d *= 65535.0
    return np_round_to_word(d)


def threshlo(data: np.ndarray, level: int) -> np.ndarray:
    """Clamp from below (siril.c:65-76)."""
    return np.maximum(data, np.uint16(level))


def threshhi(data: np.ndarray, level: int) -> np.ndarray:
    """Clamp from above (siril.c:78-89)."""
    return np.minimum(data, np.uint16(level))


def nozero(data: np.ndarray, level: int) -> np.ndarray:
    """Replace null values by level (siril.c:91-103)."""
    return np.where(data == 0, np.uint16(level), data)


def fill(data: np.ndarray, level: int, rect=None) -> np.ndarray:
    """Fill image or top-down selection with level (siril.c:696-729)."""
    out = data.copy()
    if rect is None:
        out[...] = level
        return out
    ry = data.shape[-2]
    y0 = ry - rect.y - rect.h
    out[..., y0 : y0 + rect.h, rect.x : rect.x + rect.w] = level
    return out


def off(data: np.ndarray, level: float) -> np.ndarray:
    """Add a (possibly negative) offset with WORD clamp (siril.c `off`)."""
    return np_round_to_word(data.astype(np.float64) + level)


def shift_image(data: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """Integer translate with the ii>0 quirk (siril.c `shift` :478-530)."""
    from siriltpu_torch.verify.oracle import shift_gather

    return shift_gather(data, sx, sy, fill=0, skip_origin=True)


def median_filter(data: np.ndarray, ksize: int, amount: float,
                  iterations: int = 1) -> np.ndarray:
    """fmedian: ksize median filter blended with the original
    (core/siril.c median_filter :1357-1456): out = med*amount +
    orig*(1-amount), edges clamped."""
    if ksize % 2 == 0 or ksize < 2:
        raise ValueError("The size of the kernel MUST be odd and greater than 1")
    if not 0.0 <= amount <= 1.0:
        raise ValueError("Modulation value MUST be between 0 and 1")
    r = ksize // 2
    out = data.copy()
    for _ in range(iterations):
        for c in range(out.shape[0]):
            img = out[c]
            pad = np.pad(img, r, mode="edge")
            stack = np.stack([pad[dy : dy + img.shape[0], dx : dx + img.shape[1]]
                              for dy in range(ksize) for dx in range(ksize)])
            med = np.median(stack, axis=0)
            out[c] = np_round_to_word(med * amount +
                                      img.astype(np.float64) * (1.0 - amount))
    return out


def banding_reduction(data: np.ndarray, sigma: float, amount: float,
                      protect_highlights: bool = True,
                      apply_rotation: bool = False) -> np.ndarray:
    """Canon banding reduction (BandingEngine, siril.c:1529-1615):
    per-row median vs global median difference image, scaled by amount,
    added back. Optionally operates on the 90-degree-rotated image."""
    from siriltpu_torch.ops.stats import STATS_BASIC, STATS_MAD, statistics

    work = np.rot90(data, k=1, axes=(-2, -1)).copy() if apply_rotation else data
    c, h, w = work.shape
    fix = np.zeros_like(work, dtype=np.float64)
    minimum = np.inf
    rowvals = np.zeros((c, h))
    for ch in range(c):
        st = statistics(work[ch], option=STATS_BASIC | STATS_MAD,
                        nullcheck=True)
        background = st.median
        globalsigma = st.mad * 1.4826 if protect_highlights else 0.0
        srt = np.sort(work[ch].astype(np.float64), axis=1)
        for row in range(h):
            line = srt[row]
            n = w
            if protect_highlights:
                reject = np_round_to_word(
                    np.float64(background + globalsigma / sigma))
                n = int(np.searchsorted(line, reject, side="left"))
            if n == 0:
                # every value ≥ reject: GSL median of n==0 is 0.0, so the
                # reference's rowvalue becomes the full background
                # (verified against the compiled C in test_c_goldens)
                median = 0.0
            else:
                median = (line[(n - 1) // 2] if n % 2 else
                          (line[n // 2 - 1] + line[n // 2]) / 2.0)
            rowvals[ch, row] = background - median
            minimum = min(minimum, rowvals[ch, row])
    for ch in range(c):
        for row in range(h):
            fix[ch, row, :] = float(np_round_to_word(
                np.float64(rowvals[ch, row] - minimum)))
    # fmul_layer takes `float coeff` (siril.c:1448): the scale runs in
    # f32 before round_to_WORD — reproduced (it moves .5 knife-edges)
    scaled = (fix.astype(np.float32)
              * np.float32(amount)).astype(np.float64)
    fixed = np.clip(work.astype(np.int64) +
                    np_round_to_word(scaled).astype(np.int64),
                    0, 65535).astype(np.uint16)
    if apply_rotation:
        fixed = np.rot90(fixed, k=-1, axes=(-2, -1)).copy()
    return fixed


def background_noise(data: np.ndarray, *, device) -> np.ndarray:
    """bgnoise command (backgroundnoise, siril.c:1626-1713): sigma of the
    finest wavelet scale, 3-sigma clipped iteratively (eps 1e-4, 15
    iters), scaled by 2.35482/0.974. Returns per-channel sigma. The
    wavelet transform on ``device``."""
    from siriltpu_torch.ops.stats import STATS_BASIC, statistics
    from siriltpu_torch.ops.wavelets import TO_PAVE_BSPLINE, atrous_transform

    LOW_BOUND, HIGH_BOUND = 0.00002, 0.99998
    sigmas = np.zeros(data.shape[0])
    for ch in range(data.shape[0]):
        tr = atrous_transform(frames_from_numpy(np.asarray(data[ch], np.uint16),
                                                device), 4, TO_PAVE_BSPLINE)
        plane = tr[0].cpu().numpy().astype(np.float64)
        mx = plane.max()
        ratio = 65535.0 / mx if mx > 65535.0 else 1.0
        wave = np_round_to_word(plane * ratio)
        st = statistics(wave, option=STATS_BASIC, nullcheck=True)
        if st is None:
            continue
        sigma0 = st.sigma
        mean = st.mean
        norm = st.norm_value
        lo = np_round_to_word(np.float64(LOW_BOUND * norm))
        hi = np_round_to_word(np.float64(HIGH_BOUND * norm))
        vals = wave.reshape(-1).astype(np.float64)
        sigma = sigma0
        for _ in range(15):
            s0 = sigma
            vals = vals[(vals >= lo) & (vals <= hi) &
                        (np.abs(vals - mean) < 3.0 * s0)]
            if vals.size == 0:
                sigma = 0.0
                break
            sigma = vals.std(ddof=1)
            if sigma > 0 and abs(sigma - s0) / sigma <= 1e-4:
                break
        sigmas[ch] = sigma * 2.35482 / 0.974
    return sigmas


def lrgb(l: np.ndarray, r: np.ndarray, g: np.ndarray, b: np.ndarray
         ) -> np.ndarray:
    """LRGB combination (siriltpu.ops.imops.lrgb, siril.c lrgb
    :815-884): HSI composition of the RGB channels with the luminance layer
    replacing intensity. Host NumPy (``pipelines/compositing.py:compose``)."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.pipelines.compositing import CompositionLayer, compose

    layers = [CompositionLayer(Frame(r.reshape(1, *r.shape[-2:])), (1, 0, 0)),
              CompositionLayer(Frame(g.reshape(1, *g.shape[-2:])), (0, 1, 0)),
              CompositionLayer(Frame(b.reshape(1, *b.shape[-2:])), (0, 0, 1))]
    out = compose(layers, luminance=Frame(l.reshape(1, *l.shape[-2:])))
    return out.data


__all__ = ["soper", "imoper", "fdiv", "ndiv", "addmax", "crop", "mirrorx",
           "mirrory", "rotate_pi", "entropy", "loglut", "contrast", "ddp",
           "unsharp", "resize", "rotate", "sub_background_layer", "threshlo",
           "threshhi", "nozero", "fill", "off", "shift_image", "median_filter",
           "banding_reduction", "background_noise", "lrgb",
           "OPER_ADD", "OPER_SUB", "OPER_MUL", "OPER_DIV"]
