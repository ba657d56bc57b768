"""Bayer demosaicing.

Port of ``siriltpu.ops.demosaic``. The host methods (``super_pixel``,
``bilinear``, ``nearest``, ``vng``, ``ahd`` with ``_cam_to_lab64``) are
NumPy in the JAX package and copied here: they are the exact references.
Its two jitted device programs, ``_vng_jax_fn`` and ``_ahd_jax_fn``, are
torch programs here (:func:`vng_torch`, :func:`ahd_torch`, and the host
wrappers :func:`vng_device`, :func:`ahd_device`), run on the device the
caller names. ``debayer_buffer`` sends VNG and AHD frames of 2^20 pixels
or more to them as the JAX package does, but a failure there raises: it
does not fall back to the host.

Reference: src/algos/demosaicing.c — methods (enum src/core/siril.h:249-255):
super-pixel half-size (:32-80), bilinear (OpenCV scheme, :89-175),
nearest neighbor (:177-244), VNG (:284-421), AHD (:473-665).

Conventions: input CFA is a top-down single layer as stored in SER
(callers flip afterwards, see siriltpu_torch/io/ser.py); output is (3, H, W)
uint16 in the same row order. Bilinear/nearest leave the 1-pixel border
at 0 exactly like the reference (calloc'd output, interior-only loops).
"""

from __future__ import annotations

import numpy as np
import torch

from siriltpu_torch.io.ser import (SER_BAYER_BGGR, SER_BAYER_GBRG, SER_BAYER_GRBG,
                                   SER_BAYER_RGGB)
from siriltpu_torch.utils.interop import (frames_from_numpy, i32_to_u16, u16_to_i32,
                                         u16_to_numpy)
from siriltpu_torch.utils.rounding import np_round_to_word

Tensor = torch.Tensor

BAYER_PATTERNS = ("RGGB", "BGGR", "GBRG", "GRBG")


def pattern_from_ser(color_id: int) -> str:
    """retrieveSERBayerPattern (io/ser.c)."""
    return {SER_BAYER_RGGB: "RGGB", SER_BAYER_BGGR: "BGGR",
            SER_BAYER_GBRG: "GBRG", SER_BAYER_GRBG: "GRBG"}[color_id]


def _phase_offsets(pattern: str):
    """(dy, dx) of R, G1, G2, B cells within the 2x2 tile."""
    p = pattern.upper()
    pos = {p[0]: (0, 0), p[3]: (1, 1)}
    # two greens
    greens = [(0, 1), (1, 0)]
    out = {}
    out["R"] = {"RGGB": (0, 0), "BGGR": (1, 1), "GBRG": (1, 0),
                "GRBG": (0, 1)}[p]
    out["B"] = {"RGGB": (1, 1), "BGGR": (0, 0), "GBRG": (0, 1),
                "GRBG": (1, 0)}[p]
    out["G"] = [g for g in [(0, 0), (0, 1), (1, 0), (1, 1)]
                if g not in (out["R"], out["B"])]
    return out


def super_pixel(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Half-size super-pixel debayer (demosaicing.c:32-80): R and B taken
    directly, G = round((G1+G2)/2)."""
    h, w = cfa.shape
    # reference loops row < height-1, col < width-1 with step 2
    h2 = len(range(0, h - 1, 2))
    w2 = len(range(0, w - 1, 2))
    a = cfa[: 2 * h2, : 2 * w2].astype(np.float64)
    t00 = a[0::2, 0::2]
    t01 = a[0::2, 1::2]
    t10 = a[1::2, 0::2]
    t11 = a[1::2, 1::2]
    tiles = {(0, 0): t00, (0, 1): t01, (1, 0): t10, (1, 1): t11}
    off = _phase_offsets(pattern)
    r = tiles[off["R"]]
    b = tiles[off["B"]]
    g = np_round_to_word((tiles[off["G"][0]] + tiles[off["G"][1]]) / 2.0)
    out = np.stack([r.astype(np.uint16), g, b.astype(np.uint16)])
    if (h % 2) or (w % 2):
        # Odd dimensions: the reference writes h2*w2 superpixels
        # CONTIGUOUSLY (i += 3, demosaicing.c:76) into a calloc'd buffer
        # that debayer_buffer sizes and reinterprets as ceil(h/2) x
        # ceil(w/2) (demosaicing.c:713-725) -- rows wrap and the tail is
        # zeros. Reproduce that exact (buggy) layout; verified against
        # the compiled C in tests/test_c_goldens.py.
        ch = h // 2 + h % 2
        cw = w // 2 + w % 2
        flat = np.zeros(ch * cw * 3, dtype=np.uint16)
        interleaved = np.moveaxis(out, 0, -1).reshape(-1)
        flat[: interleaved.size] = interleaved
        out = np.moveaxis(flat.reshape(ch, cw, 3), -1, 0).copy()
    return out


def bilinear(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Bilinear debayer (OpenCV scheme, demosaicing.c:89-175): missing
    colors averaged from 2/4 neighbors with (sum + n/2) >> log2(n)
    integer rounding; the 1-pixel border is left at 0.

    The Bayer phases tile 2x2, so channels assemble from strided slices
    of the four neighbor aggregates — no masks, no fancy indexing."""
    h, w = cfa.shape
    a = cfa.astype(np.int32)  # sums of 4 values stay < 2^18
    off = _phase_offsets(pattern)

    cross4 = np.zeros((h, w), dtype=np.int32)
    diag4 = np.zeros((h, w), dtype=np.int32)
    horiz2 = np.zeros((h, w), dtype=np.int32)
    vert2 = np.zeros((h, w), dtype=np.int32)
    cross4[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2] +
                          a[1:-1, 2:] + 2) >> 2
    diag4[1:-1, 1:-1] = (a[:-2, :-2] + a[:-2, 2:] + a[2:, :-2] +
                         a[2:, 2:] + 2) >> 2
    horiz2[1:-1, 1:-1] = (a[1:-1, :-2] + a[1:-1, 2:] + 1) >> 1
    vert2[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + 1) >> 1

    R = np.zeros((h, w), dtype=np.int32)
    G = np.zeros((h, w), dtype=np.int32)
    B = np.zeros((h, w), dtype=np.int32)

    def sl(ph):
        return (slice(ph[0], None, 2), slice(ph[1], None, 2))

    pr, pb = off["R"], off["B"]
    R[sl(pr)] = a[sl(pr)]; G[sl(pr)] = cross4[sl(pr)]; B[sl(pr)] = diag4[sl(pr)]
    B[sl(pb)] = a[sl(pb)]; G[sl(pb)] = cross4[sl(pb)]; R[sl(pb)] = diag4[sl(pb)]
    r_row = off["R"][0]
    for pg in off["G"]:
        s = sl(pg)
        G[s] = a[s]
        if pg[0] == r_row:   # green in an R row
            R[s] = horiz2[s]; B[s] = vert2[s]
        else:                # green in a B row
            R[s] = vert2[s]; B[s] = horiz2[s]

    out = np.stack([np.clip(R, 0, 65535).astype(np.uint16),
                    np.clip(G, 0, 65535).astype(np.uint16),
                    np.clip(B, 0, 65535).astype(np.uint16)])
    out[:, 0, :] = 0; out[:, -1, :] = 0
    out[:, :, 0] = 0; out[:, :, -1] = 0
    return out


def nearest(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """Nearest-neighbor debayer (bayer_NearestNeighbor,
    demosaicing.c:177-283), exact array re-derivation of the C's paired
    scan, verified against the compiled reference
    (tests/test_c_goldens.py):

    - last row and last column are black (the "black border");
    - each row alternates ``blue`` sign and ``start_with_green``;
    - a start-with-green row emits one leading pixel from its right/down
      neighbors, then the paired loop;
    - pairs: first-of-pair (and the odd tail) take (cur, right, diag),
      second-of-pair takes (right, diag, down) -- with the first/third
      channel swapped on blue<0 rows.
    """
    h, w = cfa.shape
    a = cfa.astype(np.uint16)
    out = np.zeros((3, h, w), dtype=np.uint16)
    if h < 2 or w < 2:
        return out
    blue0 = -1 if pattern.upper() in ("BGGR", "GBRG") else 1
    swg0 = 1 if pattern.upper() in ("GBRG", "GRBG") else 0

    cur = a[:-1, :-1]
    right = a[:-1, 1:]
    down = a[1:, :-1]
    diag = a[1:, 1:]
    rr, cc = np.mgrid[0: h - 1, 0: w - 1]
    blue_pos = ((rr & 1) == 0) if blue0 == 1 else ((rr & 1) == 1)
    s = swg0 ^ (rr & 1)  # per-row start_with_green
    lead = (cc == 0) & (s == 1)
    first = ~lead & (((cc - s) & 1) == 0)
    # X1 = the rgb[-blue] channel source, X2 = the rgb[blue] source
    x1 = np.where(lead, right, np.where(first, cur, right))
    g = np.where(lead, diag, np.where(first, right, diag))
    x2 = np.where(lead, down, np.where(first, diag, down))
    out[0, :-1, :-1] = np.where(blue_pos, x1, x2)
    out[1, :-1, :-1] = g
    out[2, :-1, :-1] = np.where(blue_pos, x2, x1)
    return out


def debayer_buffer(cfa: np.ndarray, pattern: str,
                   method: str = "bilinear", *, device) -> np.ndarray:
    """``debayer_buffer`` (demosaicing.c:667-728): dispatch by method.
    VNG and AHD frames of 2^20 pixels or more run on ``device`` (None
    refuses them), smaller ones on the host as in the JAX package."""
    cfa = np.asarray(cfa, dtype=np.uint16)
    method = method.lower()
    if method in ("super_pixel", "superpixel", "super-pixel"):
        return super_pixel(cfa, pattern)
    if method in ("nearest", "nearestneighbor"):
        return nearest(cfa, pattern)
    if method == "vng":
        if cfa.size >= (1 << 20):
            return vng_device(cfa, pattern, device=device)
        return vng(cfa, pattern)
    if method == "ahd":
        if cfa.size >= (1 << 20):
            return ahd_device(cfa, pattern, device=device)
        return ahd(cfa, pattern)
    if method == "bilinear":
        return bilinear(cfa, pattern)
    raise ValueError(f"unknown debayer method {method}")


__all__ = ["debayer_buffer", "super_pixel", "bilinear", "nearest", "vng",
           "vng_device", "vng_torch", "ahd", "ahd_device", "ahd_torch",
           "pattern_from_ser", "BAYER_PATTERNS"]


# ------------------------------------------------------------------- VNG

_VNG_TERMS = [
    -2, -2, +0, -1, 0, 0x01, -2, -2, +0, +0, 1, 0x01, -2, -1, -1, +0, 0, 0x01,
    -2, -1, +0, -1, 0, 0x02, -2, -1, +0, +0, 0, 0x03, -2, -1, +0, +1, 1, 0x01,
    -2, +0, +0, -1, 0, 0x06, -2, +0, +0, +0, 1, 0x02, -2, +0, +0, +1, 0, 0x03,
    -2, +1, -1, +0, 0, 0x04, -2, +1, +0, -1, 1, 0x04, -2, +1, +0, +0, 0, 0x06,
    -2, +1, +0, +1, 0, 0x02, -2, +2, +0, +0, 1, 0x04, -2, +2, +0, +1, 0, 0x04,
    -1, -2, -1, +0, 0, 0x80, -1, -2, +0, -1, 0, 0x01, -1, -2, +1, -1, 0, 0x01,
    -1, -2, +1, +0, 1, 0x01, -1, -1, -1, +1, 0, 0x88, -1, -1, +1, -2, 0, 0x40,
    -1, -1, +1, -1, 0, 0x22, -1, -1, +1, +0, 0, 0x33, -1, -1, +1, +1, 1, 0x11,
    -1, +0, -1, +2, 0, 0x08, -1, +0, +0, -1, 0, 0x44, -1, +0, +0, +1, 0, 0x11,
    -1, +0, +1, -2, 1, 0x40, -1, +0, +1, -1, 0, 0x66, -1, +0, +1, +0, 1, 0x22,
    -1, +0, +1, +1, 0, 0x33, -1, +0, +1, +2, 1, 0x10, -1, +1, +1, -1, 1, 0x44,
    -1, +1, +1, +0, 0, 0x66, -1, +1, +1, +1, 0, 0x22, -1, +1, +1, +2, 0, 0x10,
    -1, +2, +0, +1, 0, 0x04, -1, +2, +1, +0, 1, 0x04, -1, +2, +1, +1, 0, 0x04,
    +0, -2, +0, +0, 1, 0x80, +0, -1, +0, +1, 1, 0x88, +0, -1, +1, -2, 0, 0x40,
    +0, -1, +1, +0, 0, 0x11, +0, -1, +2, -2, 0, 0x40, +0, -1, +2, -1, 0, 0x20,
    +0, -1, +2, +0, 0, 0x30, +0, -1, +2, +1, 1, 0x10, +0, +0, +0, +2, 1, 0x08,
    +0, +0, +2, -2, 1, 0x40, +0, +0, +2, -1, 0, 0x60, +0, +0, +2, +0, 1, 0x20,
    +0, +0, +2, +1, 0, 0x30, +0, +0, +2, +2, 1, 0x10, +0, +1, +1, +0, 0, 0x44,
    +0, +1, +1, +2, 0, 0x10, +0, +1, +2, -1, 1, 0x40, +0, +1, +2, +0, 0, 0x60,
    +0, +1, +2, +1, 0, 0x20, +0, +1, +2, +2, 0, 0x10, +1, -2, +1, +0, 0, 0x80,
    +1, -1, +1, +1, 0, 0x88, +1, +0, +1, +2, 0, 0x08, +1, +0, +2, -1, 0, 0x40,
    +1, +0, +2, +1, 0, 0x10,
]
_VNG_CHOOD = [-1, -1, -1, 0, -1, +1, 0, +1, +1, +1, +1, 0, +1, -1, 0, -1]

_VNG_FILTERS = {"BGGR": 0x16161616, "GRBG": 0x61616161,
                "RGGB": 0x94949494, "GBRG": 0x49494949}


def _fc(filters: int, row: int, col: int) -> int:
    return (filters >> ((((row << 1) & 14) + (col & 1)) << 1)) & 3


def vng(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """VNG demosaic — an exact array-program port of the dcraw-derived
    ``bayer_VNG`` (demosaicing.c:246-421).

    The reference delays write-back by two rows, so every gradient and
    neighbor read sees BILINEAR values; reading from the bilinear result
    and writing a fresh output reproduces it exactly. Pixels sharing
    (row & 7, col & 1) share the precalculated code table, so each of
    the 16 classes vectorizes over a strided subgrid.
    """
    cfa = np.asarray(cfa, dtype=np.uint16)
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    rgb = bilinear(cfa, pattern)
    img = rgb.astype(np.int32)  # diffs << 2 and 8-term sums stay < 2^22
    out = rgb.copy()

    for r8 in range(8):
        # rows in [2, h-2) with row & 7 == r8 form an arithmetic slice:
        # strided VIEWS replace np.ix_ fancy-index copies (the old form
        # made ~1000 copying gathers per image)
        start_r = r8 if r8 >= 2 else r8 + 8
        if start_r >= h - 2:
            continue
        nrows = len(range(start_r, h - 2, 8))
        for c2 in range(2):
            start_c = c2 if c2 >= 2 else c2 + 2
            if start_c >= w - 2:
                continue
            ncols = len(range(start_c, w - 2, 2))

            def sub(ch, dy, dx):
                return img[ch,
                           start_r + dy : start_r + dy + 8 * nrows : 8,
                           start_c + dx : start_c + dx + 2 * ncols : 2]

            color = _fc(filters, r8, c2)
            # ---- gradients (bayervng_terms decode, demosaicing.c:316-341)
            gval = np.zeros((8, nrows, ncols), dtype=np.int32)
            t = 0
            while t < len(_VNG_TERMS):
                y1, x1, y2, x2, weight, grads = _VNG_TERMS[t : t + 6]
                t += 6
                c1 = _fc(filters, r8 + y1, c2 + x1)
                if _fc(filters, r8 + y2, c2 + x2) != c1:
                    continue
                diag = 2 if (_fc(filters, r8, c2 + 1) == c1 and
                             _fc(filters, r8 + 1, c2) == c1) else 1
                if abs(y1 - y2) == diag and abs(x1 - x2) == diag:
                    continue
                diff = np.abs(sub(c1, y1, x1) -
                              sub(c1, y2, x2)) << weight
                for g in range(8):
                    if grads & (1 << g):
                        gval[g] += diff
            gmin = gval.min(axis=0)
            gmax = gval.max(axis=0)
            thold = gmin + (gmax >> 1)
            # ---- average the low-gradient directions (chood decode)
            sums = np.zeros((3, nrows, ncols), dtype=np.int32)
            num = np.zeros((nrows, ncols), dtype=np.int32)
            for g in range(8):
                dy, dx = _VNG_CHOOD[2 * g], _VNG_CHOOD[2 * g + 1]
                pair = (_fc(filters, r8 + dy, c2 + dx) != color and
                        _fc(filters, r8 + 2 * dy, c2 + 2 * dx) == color)
                use = gval[g] <= thold
                for c in range(3):
                    if c == color and pair:
                        contrib = (sub(c, 0, 0) +
                                   sub(color, 2 * dy, 2 * dx)) >> 1
                    else:
                        contrib = sub(c, dy, dx)
                    sums[c] += np.where(use, contrib, 0)
                num += use
            center = sub(color, 0, 0)
            numsafe = np.maximum(num, 1)
            for c in range(3):
                tval = center.astype(np.float64)
                if True:
                    dsum = sums[c] - sums[color]
                    # C integer division truncates toward zero
                    q = np.trunc(dsum / numsafe)
                    tval = np.where(c == color, tval, tval + q)
                vals = np_round_to_word(tval)
                keep = gmax == 0  # untouched pixels keep bilinear values
                view = out[c,
                           start_r : start_r + 8 * nrows : 8,
                           start_c : start_c + 2 * ncols : 2]
                view[...] = np.where(keep, view, vals)
    return out


# ------------------------------------------------------------ on a device

def _shift(a: Tensor, dy: int, dx: int) -> Tensor:
    """out[..., y, x] = a[..., y - dy, x - dx], zero fill (matches the
    host's ``shift``)."""
    h, w = a.shape[-2:]
    out = torch.zeros_like(a)
    ys0, ys1 = max(dy, 0), min(h + dy, h)
    xs0, xs1 = max(dx, 0), min(w + dx, w)
    out[..., ys0:ys1, xs0:xs1] = a[..., ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
    return out


def _iota(h: int, w: int, device):
    """(row, column) index planes, int32, on ``device``."""
    yy = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return yy, xx


def _bilinear_torch(a: Tensor, filters: int) -> Tensor:
    """:func:`bilinear` in integer torch ops on an (H, W) int32 CFA:
    neighbour aggregates from slices, each phase's channels picked by
    parity masks. (3, H, W) int32 in [0, 65535], border 0."""
    h, w = a.shape
    cross4, diag4, horiz2, vert2 = (torch.zeros_like(a) for _ in range(4))
    cross4[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + a[1:-1, :-2]
                          + a[1:-1, 2:] + 2) >> 2
    diag4[1:-1, 1:-1] = (a[:-2, :-2] + a[:-2, 2:] + a[2:, :-2] + a[2:, 2:] + 2) >> 2
    horiz2[1:-1, 1:-1] = (a[1:-1, :-2] + a[1:-1, 2:] + 1) >> 1
    vert2[1:-1, 1:-1] = (a[:-2, 1:-1] + a[2:, 1:-1] + 1) >> 1
    yy, xx = _iota(h, w, a.device)
    py, px = yy & 1, xx & 1
    is_r = torch.zeros((h, w), dtype=torch.bool, device=a.device)
    is_b = is_r.clone()
    r_row = 0
    for ry in (0, 1):
        for rx in (0, 1):
            color = _fc(filters, ry, rx)
            m = (py == ry) & (px == rx)
            if color == 0:
                is_r |= m
                r_row = ry
            elif color == 2:
                is_b |= m
    is_g = ~(is_r | is_b)
    in_r_row = py == r_row
    R = torch.where(is_r, a, torch.where(is_b, diag4,
                    torch.where(in_r_row, horiz2, vert2)))
    G = torch.where(is_g, a, cross4)
    B = torch.where(is_b, a, torch.where(is_r, diag4,
                    torch.where(in_r_row, vert2, horiz2)))
    rgb = torch.stack([R, G, B]).clamp_(0, 65535)
    rgb[:, 0, :] = 0
    rgb[:, -1, :] = 0
    rgb[:, :, 0] = 0
    rgb[:, :, -1] = 0
    return rgb


def vng_torch(cfa: Tensor, pattern: str) -> Tensor:
    """:func:`vng` in integer torch ops on the device of ``cfa``, an
    (H, W) uint16 tensor; returns (3, H, W) uint16 there. The JAX
    package's ``_vng_jax_fn`` (demosaic.py:512-672) in torch: the 16
    (row & 7, col & 1) classes each read stride-8/stride-2 views of the
    bilinear image and write their block of a fresh output, every
    quantity an int32, the C truncating division ``sign * (|d| // n)``.
    Bit-equal to :func:`vng`."""
    filters = _VNG_FILTERS[pattern.upper()]
    h, w = cfa.shape
    img = _bilinear_torch(u16_to_i32(cfa), filters)
    out = img.clone()
    for r8 in range(8):
        start_r = r8 if r8 >= 2 else r8 + 8
        if start_r >= h - 2:
            continue
        nrows = len(range(start_r, h - 2, 8))
        for c2 in range(2):
            start_c = c2 + 2
            if start_c >= w - 2:
                continue
            ncols = len(range(start_c, w - 2, 2))

            def sub(ch, dy, dx, src=img):
                return src[ch, start_r + dy: start_r + dy + 8 * nrows: 8,
                           start_c + dx: start_c + dx + 2 * ncols: 2]

            color = _fc(filters, r8, c2)
            gval = torch.zeros((8, nrows, ncols), dtype=torch.int32, device=cfa.device)
            for t in range(0, len(_VNG_TERMS), 6):
                y1, x1, y2, x2, weight, grads = _VNG_TERMS[t: t + 6]
                c1 = _fc(filters, r8 + y1, c2 + x1)
                if _fc(filters, r8 + y2, c2 + x2) != c1:
                    continue
                diag = 2 if (_fc(filters, r8, c2 + 1) == c1 and
                             _fc(filters, r8 + 1, c2) == c1) else 1
                if abs(y1 - y2) == diag and abs(x1 - x2) == diag:
                    continue
                diff = (sub(c1, y1, x1) - sub(c1, y2, x2)).abs() << weight
                for g in range(8):
                    if grads & (1 << g):
                        gval[g] += diff
            gmin = gval.amin(dim=0)
            gmax = gval.amax(dim=0)
            thold = gmin + (gmax >> 1)
            sums = torch.zeros((3, nrows, ncols), dtype=torch.int32, device=cfa.device)
            num = torch.zeros((nrows, ncols), dtype=torch.int32, device=cfa.device)
            for g in range(8):
                dy, dx = _VNG_CHOOD[2 * g], _VNG_CHOOD[2 * g + 1]
                pair = (_fc(filters, r8 + dy, c2 + dx) != color and
                        _fc(filters, r8 + 2 * dy, c2 + 2 * dx) == color)
                use = (gval[g] <= thold).to(torch.int32)
                for c in range(3):
                    if c == color and pair:
                        contrib = (sub(c, 0, 0) + sub(color, 2 * dy, 2 * dx)) >> 1
                    else:
                        contrib = sub(c, dy, dx)
                    sums[c] += use * contrib
                num += use
            center = sub(color, 0, 0)
            numsafe = num.clamp(min=1)
            keep = gmax == 0   # untouched pixels keep their bilinear values
            for c in range(3):
                if c == color:
                    vals = center
                else:
                    dsum = sums[c] - sums[color]
                    vals = center + torch.sign(dsum) * (dsum.abs() // numsafe)
                view = sub(c, 0, 0, out)
                view.copy_(torch.where(keep, view, vals.clamp(0, 65535)))
    return i32_to_u16(out)


def _cam_to_lab_torch(rgb3: Tensor, lut: Tensor) -> Tensor:
    """:func:`_cam_to_lab64` in torch: (3, H, W) int32 -> int32 lab*64.
    Each channel of the 3 x 3 transform is a chain of float32 fused
    multiply-adds, as NumPy's ``tensordot`` (its BLAS) and XLA compute it:
    emulated in float64, where each product is exact, with each sum
    rounded to float32. The LUT index is rounded in float64 as
    ``np_round_to_word``."""
    cam = rgb3.to(torch.float64)
    xyz_cam = (_XYZ_RGB / _D65[:, None]).astype(np.float32)
    idx = []
    for c in range(3):
        m = [float(v) for v in xyz_cam[c]]
        acc = (m[0] * cam[0]).to(torch.float32)
        for k in (1, 2):
            acc = (m[k] * cam[k] + acc.to(torch.float64)).to(torch.float32)
        xyz = (acc + 0.5).to(torch.float64)
        idx.append(torch.floor(xyz + 0.5).clamp(0, 65535).long())
    f = [lut[i] for i in idx]
    L = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    lab = torch.stack([L, a, b]) * 64.0
    return torch.trunc(lab).to(torch.int32)


def ahd_torch(cfa: Tensor, pattern: str) -> Tensor:
    """:func:`ahd` in torch on the device of ``cfa``, an (H, W) uint16
    tensor; returns (3, H, W) uint16 there. The JAX package's
    ``_ahd_jax_fn`` (demosaic.py:344-496) in torch: integer ops
    throughout, and the chroma differences squared in int64 as the host
    does (the JAX package squares them in float32). What can still part
    from :func:`ahd` is the float32 3 x 3 colour transform ahead of the
    CIELAB table (:func:`_cam_to_lab_torch`): where the host's BLAS sums
    ``tensordot`` in another order than a chain of fused multiply-adds, a
    knife-edge moves the table index by one (PARITY.md #7)."""
    global _CBRT_LUT
    if _CBRT_LUT is None:
        _CBRT_LUT = _ahd_cbrt_lut()
    dev = cfa.device
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    lut = torch.from_numpy(_CBRT_LUT).to(dev)
    iy, ix = _iota(h, w, dev)
    fcmap = (filters >> ((((iy << 1) & 14) + (ix & 1)) << 1)) & 3
    own = u16_to_i32(cfa)
    at = [fcmap == c for c in range(3)]
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- border_interpolate(3)
    is_border = (iy < 3) | (iy >= h - 3) | (ix < 3) | (ix >= w - 3)
    dst = []
    for c in range(3):
        vals = torch.where(at[c], own, zero)
        known = at[c].to(torch.int32)
        s3 = sum(_shift(vals, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        c3 = sum(_shift(known, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
        fill = is_border & ~at[c] & (c3 > 0)
        dst.append(torch.where(fill, s3 // c3.clamp(min=1), vals))
    g_cfa = dst[1]

    # ---- green H / V candidates at non-green positions
    valid_g = (iy >= 2) & (iy < h - 2) & (ix >= 2) & (ix < w - 2) & ~at[1]
    gl, gr = _shift(g_cfa, 0, 1), _shift(g_cfa, 0, -1)
    vh = ((gl + own + gr) * 2 - _shift(own, 0, 2) - _shift(own, 0, -2)) >> 2
    gh = torch.minimum(torch.maximum(vh, torch.minimum(gl, gr)), torch.maximum(gl, gr))
    gu, gd = _shift(g_cfa, 1, 0), _shift(g_cfa, -1, 0)
    vv = ((gu + own + gd) * 2 - _shift(own, 2, 0) - _shift(own, -2, 0)) >> 2
    gv = torch.minimum(torch.maximum(vv, torch.minimum(gu, gd)), torch.maximum(gu, gd))

    inner = (iy >= 1) & (iy < h - 1) & (ix >= 1) & (ix < w - 1)
    c_below = torch.roll(fcmap, -1, dims=0)
    outs, labs = [], []
    for gcand in (gh, gv):
        G = torch.where(at[1], own, torch.where(valid_g, gcand, zero))
        ch = [torch.zeros_like(own), G, torch.zeros_like(own)]
        for cb in (0, 2):
            m = at[1] & inner & (c_below == cb)
            hcol = 2 - cb
            val_h = own + ((_shift(dst[hcol], 0, 1) + _shift(dst[hcol], 0, -1)
                            - _shift(G, 0, 1) - _shift(G, 0, -1)) >> 1)
            val_v = own + ((_shift(dst[cb], 1, 0) + _shift(dst[cb], -1, 0)
                            - _shift(G, 1, 0) - _shift(G, -1, 0)) >> 1)
            ch[hcol] = torch.where(m, val_h.clamp(0, 65535), ch[hcol])
            ch[cb] = torch.where(m, val_v.clamp(0, 65535), ch[cb])
        diag_g = (_shift(G, 1, 1) + _shift(G, 1, -1)
                  + _shift(G, -1, 1) + _shift(G, -1, -1))
        for fc_ in (0, 2):
            o = 2 - fc_
            m = at[fc_] & inner
            diag_o = (_shift(dst[o], 1, 1) + _shift(dst[o], 1, -1)
                      + _shift(dst[o], -1, 1) + _shift(dst[o], -1, -1))
            val = G + ((diag_o - diag_g + 1) >> 2)
            ch[o] = torch.where(m, val.clamp(0, 65535), ch[o])
            ch[fc_] = torch.where(m, own, ch[fc_])
        rgbd = torch.stack(ch)
        outs.append(rgbd)
        labs.append(_cam_to_lab_torch(rgbd, lut))

    # ---- homogeneity maps; dirs: col-1, col+1, row-1, row+1
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))
    ldiff = [[None] * 4 for _ in range(2)]
    abdiff = [[None] * 4 for _ in range(2)]
    for d in range(2):
        L, A, B = labs[d][0], labs[d][1].long(), labs[d][2].long()
        for i, (dy, dx) in enumerate(dirs):
            ldiff[d][i] = (L - _shift(L, dy, dx)).abs()
            abdiff[d][i] = (A - _shift(A, dy, dx)) ** 2 + (B - _shift(B, dy, dx)) ** 2
    leps = torch.minimum(torch.maximum(ldiff[0][0], ldiff[0][1]),
                         torch.maximum(ldiff[1][2], ldiff[1][3]))
    abeps = torch.minimum(torch.maximum(abdiff[0][0], abdiff[0][1]),
                          torch.maximum(abdiff[1][2], abdiff[1][3]))
    hvalid = (iy >= 2) & (iy < h - 2) & (ix >= 2) & (ix < w - 2)
    homo = [sum((hvalid & (ldiff[d][i] <= leps) & (abdiff[d][i] <= abeps))
                .to(torch.int32) for i in range(4)) for d in range(2)]

    # ---- combine: 3x3 homogeneity vote on rows/cols [3, n-4]
    hm = [sum(_shift(homo[d], dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
          for d in range(2)]
    final = (iy >= 3) & (iy < h - 3) & (ix >= 3) & (ix < w - 3)
    use_v = hm[1] > hm[0]
    tie = hm[0] == hm[1]
    res = []
    for c in range(3):
        pick = torch.where(use_v, outs[1][c], outs[0][c])
        avg = (outs[0][c] + outs[1][c]) >> 1
        val = torch.where(tie, avg, pick).clamp(0, 65535)
        res.append(torch.where(final, val, dst[c].clamp(0, 65535)))
    return i32_to_u16(torch.stack(res))


def _on_device(fn, cfa: np.ndarray, pattern: str, device) -> np.ndarray:
    if device is None:
        raise ValueError("VNG and AHD debayering of a frame of 2^20 pixels or "
                         "more runs on a device: pass device=")
    cfa = np.asarray(cfa, dtype=np.uint16)
    return u16_to_numpy(fn(frames_from_numpy(cfa, device), pattern))


def vng_device(cfa: np.ndarray, pattern: str, *, device) -> np.ndarray:
    """VNG on ``device`` (:func:`vng_torch`), host arrays in and out.
    Bit-identical to :func:`vng`."""
    return _on_device(vng_torch, cfa, pattern, device)


def ahd_device(cfa: np.ndarray, pattern: str, *, device) -> np.ndarray:
    """AHD on ``device`` (:func:`ahd_torch`), host arrays in and out; see
    there for its one float32 knife-edge against the host :func:`ahd`."""
    return _on_device(ahd_torch, cfa, pattern, device)


# ------------------------------------------------------------------- AHD

_XYZ_RGB = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_D65 = np.array([0.950456, 1.0, 1.088754])


def _ahd_cbrt_lut() -> np.ndarray:
    i = np.arange(0x10000, dtype=np.float32)
    r = i / np.float32(65535.0)
    return np.where(r > 0.008856, np.cbrt(r),
                    np.float32(7.787) * r + np.float32(16.0 / 116)
                    ).astype(np.float32)


_CBRT_LUT = None


def _cam_to_lab64(rgb3: np.ndarray) -> np.ndarray:
    """cam_to_cielab (demosaicing.c:433-466) vectorized: rgb3 (3, H, W)
    uint16 -> int16 lab*64 (C truncation to short)."""
    global _CBRT_LUT
    if _CBRT_LUT is None:
        _CBRT_LUT = _ahd_cbrt_lut()
    xyz_cam = (_XYZ_RGB / _D65[:, None]).astype(np.float32)
    cam = rgb3.astype(np.float32)
    xyz = np.tensordot(xyz_cam, cam, axes=1) + np.float32(0.5)
    idx = np_round_to_word(xyz.astype(np.float64))
    f = _CBRT_LUT[idx]
    L = np.float32(116) * f[1] - np.float32(16)
    a = np.float32(500) * (f[0] - f[1])
    b = np.float32(200) * (f[1] - f[2])
    lab = np.stack([L, a, b]) * np.float32(64)
    return np.trunc(lab).astype(np.int16)


def ahd(cfa: np.ndarray, pattern: str) -> np.ndarray:
    """AHD demosaic — exact array-program port of the dcraw-derived
    ``bayer_AHD`` (demosaicing.c:473-665, Hirakawa-Parks adaptive
    homogeneity-directed interpolation).

    The reference tiles at TS=256 purely to bound memory; the dependency
    cone of every output pixel is identical in a full-image computation
    (verified against a literal transcription), so each step vectorizes:
    green H/V candidates, R/B from green differences, CIELAB via the
    cbrt LUT, homogeneity maps, 3x3 homogeneity vote.
    """
    cfa = np.asarray(cfa, dtype=np.int64)
    h, w = cfa.shape
    filters = _VNG_FILTERS[pattern.upper()]
    yy, xx = np.mgrid[0:h, 0:w]
    fcmap = (((yy << 1) & 14) + (xx & 1))
    fcmap = (filters >> (fcmap << 1)) & 3

    # known CFA values placed; everything else 0
    dst = np.zeros((3, h, w), dtype=np.int64)
    for c in range(3):
        m = fcmap == c
        dst[c][m] = cfa[m]

    # ---- border_interpolate(3) (demosaicing.c:521-546)
    border = 3
    is_border = np.zeros((h, w), dtype=bool)
    is_border[:border, :] = True
    is_border[h - border :, :] = True
    is_border[:, :border] = True
    is_border[:, w - border :] = True
    for c in range(3):
        known = (fcmap == c).astype(np.int64)
        vals = np.where(fcmap == c, cfa, 0)
        ps = np.pad(vals, 1)
        pc = np.pad(known, 1)
        s3 = sum(ps[dy : dy + h, dx : dx + w]
                 for dy in range(3) for dx in range(3))
        c3 = sum(pc[dy : dy + h, dx : dx + w]
                 for dy in range(3) for dx in range(3))
        fill = is_border & (fcmap != c) & (c3 > 0)
        dst[c][fill] = (s3[fill] // np.maximum(c3[fill], 1))

    g_cfa = dst[1]

    def shift(a, dy, dx, fill=0):
        out = np.full_like(a, fill)
        ys0, ys1 = max(dy, 0), min(h + dy, h)
        xs0, xs1 = max(dx, 0), min(w + dx, w)
        out[ys0:ys1, xs0:xs1] = a[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
        return out

    nong = fcmap != 1
    # value of the pixel's own CFA color at every position
    own = cfa

    # ---- green H / V candidates at non-green positions (:560-577)
    valid_g = np.zeros((h, w), dtype=bool)
    valid_g[2 : h - 2, 2 : w - 2] = True
    valid_g &= nong
    gl = shift(g_cfa, 0, 1)    # green at col-1 (value from left)
    gr = shift(g_cfa, 0, -1)   # green at col+1
    fl2 = shift(own, 0, 2)
    fr2 = shift(own, 0, -2)
    vh = ((gl + own + gr) * 2 - fl2 - fr2) >> 2
    gh = np.clip(vh, np.minimum(gl, gr), np.maximum(gl, gr))  # ULIM
    gu = shift(g_cfa, 1, 0)
    gd = shift(g_cfa, -1, 0)
    fu2 = shift(own, 2, 0)
    fd2 = shift(own, -2, 0)
    vv = ((gu + own + gd) * 2 - fu2 - fd2) >> 2
    gv = np.clip(vv, np.minimum(gu, gd), np.maximum(gu, gd))

    out = [np.zeros((3, h, w), dtype=np.int64), None]
    labs = [None, None]
    inner = np.zeros((h, w), dtype=bool)
    inner[1 : h - 1, 1 : w - 1] = True
    at_g = fcmap == 1
    for d, gcand in enumerate((gh, gv)):
        G = np.where(valid_g, gcand, 0)
        G = np.where(at_g, own, G)  # greens keep their CFA value
        rgbd = np.zeros((3, h, w), dtype=np.int64)
        rgbd[1] = G
        # at green pixels: c = FC(row+1, col) (:585-596)
        c_below = np.roll(fcmap, -1, axis=0)
        for cb in (0, 2):
            m = at_g & inner & (c_below == cb)
            hcol = 2 - cb
            val_h = own + ((shift(dst[hcol], 0, 1) + shift(dst[hcol], 0, -1)
                            - shift(G, 0, 1) - shift(G, 0, -1)) >> 1)
            val_v = own + ((shift(dst[cb], 1, 0) + shift(dst[cb], -1, 0)
                            - shift(G, 1, 0) - shift(G, -1, 0)) >> 1)
            rgbd[hcol][m] = np.clip(val_h, 0, 65535)[m]
            rgbd[cb][m] = np.clip(val_v, 0, 65535)[m]
        # at non-green pixels: opposite color from diagonals (:597-607)
        diag_g = (shift(G, 1, 1) + shift(G, 1, -1) +
                  shift(G, -1, 1) + shift(G, -1, -1))
        for fc_ in (0, 2):
            o = 2 - fc_
            m = (fcmap == fc_) & inner
            diag_o = (shift(dst[o], 1, 1) + shift(dst[o], 1, -1) +
                      shift(dst[o], -1, 1) + shift(dst[o], -1, -1))
            val = G + ((diag_o - diag_g + 1) >> 2)
            rgbd[o][m] = np.clip(val, 0, 65535)[m]
            rgbd[fc_][m] = own[m]
        out[d] = rgbd
        labs[d] = _cam_to_lab64(rgbd.astype(np.uint16))

    # ---- homogeneity maps (:609-637); dirs: col-1, col+1, row-1, row+1
    dirs = ((0, 1), (0, -1), (1, 0), (-1, 0))
    ldiff = np.zeros((2, 4, h, w), dtype=np.int64)
    abdiff = np.zeros((2, 4, h, w), dtype=np.int64)
    for d in range(2):
        L = labs[d][0].astype(np.int64)
        A = labs[d][1].astype(np.int64)
        B = labs[d][2].astype(np.int64)
        for i, (dy, dx) in enumerate(dirs):
            ldiff[d, i] = np.abs(L - shift(L, dy, dx))
            abdiff[d, i] = ((A - shift(A, dy, dx)) ** 2 +
                            (B - shift(B, dy, dx)) ** 2)
    leps = np.minimum(np.maximum(ldiff[0, 0], ldiff[0, 1]),
                      np.maximum(ldiff[1, 2], ldiff[1, 3]))
    abeps = np.minimum(np.maximum(abdiff[0, 0], abdiff[0, 1]),
                       np.maximum(abdiff[1, 2], abdiff[1, 3]))
    homo = np.zeros((2, h, w), dtype=np.int64)
    hvalid = np.zeros((h, w), dtype=bool)
    hvalid[2 : h - 2, 2 : w - 2] = True
    for d in range(2):
        for i in range(4):
            homo[d] += (hvalid & (ldiff[d, i] <= leps) &
                        (abdiff[d, i] <= abeps))

    # ---- combine (:639-658): 3x3 homogeneity vote on rows/cols [3, n-4]
    hm = np.zeros((2, h, w), dtype=np.int64)
    for d in range(2):
        p = np.pad(homo[d], 1)
        hm[d] = sum(p[dy : dy + h, dx : dx + w]
                    for dy in range(3) for dx in range(3))
    final = np.zeros((h, w), dtype=bool)
    final[3 : h - 3, 3 : w - 3] = True
    use_v = hm[1] > hm[0]
    tie = hm[0] == hm[1]
    result = dst.copy()
    for c in range(3):
        pick = np.where(use_v, out[1][c], out[0][c])
        avg = (out[0][c] + out[1][c]) >> 1
        val = np.where(tie, avg, pick)
        result[c][final] = np.clip(val, 0, 65535)[final]
    return np.clip(result, 0, 65535).astype(np.uint16)
