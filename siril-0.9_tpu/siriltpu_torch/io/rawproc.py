"""libraw/dcraw postprocess semantics for the demosaiced raw path.

The reference's ``readraw`` (image_formats_libraries.c:664-828) hands the
CFA to libraw's dcraw_process with a fixed knob set: output_bps=16,
no_auto_bright=1, output_color=0 (raw space, no camera matrix),
user_flip=0, plus the user's white-balance / gamma / brightness settings
from the initfile's libraw-settings section (initfile.c:70-91).  Under
those knobs libraw's pipeline reduces to exactly three stages around the
demosaic:

1. ``scale_colors`` (dcraw.c): choose the four channel multipliers
   (user > camera WB > auto WB > daylight), normalize them by the
   minimum (highlight=0 makes dmax=dmin), and scale every CFA sample by
   ``(pre_mul[c]/dmin) * 65535/(maximum-black)`` after black
   subtraction, truncated toward zero and clipped to [0, 65535].
2. the demosaic interpolation (user_qual).
3. the output gamma LUT (dcraw.c ``gamma_curve`` with mode=2): with
   no_auto_bright the white point is fixed at 0x2000, so the LUT domain
   max is ``(0x2000 << 3) / bright`` — brightness is a linear pre-gamma
   scale.  The reference passes ``pwr = 1/raw_set.gamm[0]`` and
   ``ts = raw_set.gamm[1]``.

This module implements those stages vectorized (the demosaic itself
lives in :mod:`siriltpu_torch.ops.demosaic` and runs on device); the literal
float64 re-derivation used as the test golden is
:func:`siriltpu_torch.verify.oracle.libraw_gamma_curve` /
``libraw_scale_colors`` / ``libraw_auto_wb``.

With the reference's DEFAULT knobs (conversion.c:233-245: mul=1, auto=1,
bright=1, gamm=(1,1), user_black=0, no metadata black/maximum) every
stage is the identity, so the default demosaiced path is unchanged.

Port of ``siriltpu.io.rawproc``: copied (host NumPy). The oracles it is
tested against are the port's own copies in ``verify.oracle``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

#: CFA channel index per Bayer cell, dcraw FC() semantics collapsed to
#: 3 colors (both greens -> 1, like filters-based fcol for RGGB-class
#: patterns; channel 3 is the unused second green, pre_mul[3] inherits
#: pre_mul[1] per scale_colors)
_CH = {"R": 0, "G": 1, "B": 2}


def _channel_map(pattern: str) -> np.ndarray:
    """(2, 2) channel index (0=R, 1=G, 2=B) for the Bayer pattern."""
    p = pattern.upper()
    if sorted(p) != ["B", "G", "G", "R"]:
        raise ValueError(f"not a Bayer pattern: {pattern}")
    return np.array([[_CH[p[0]], _CH[p[1]]], [_CH[p[2]], _CH[p[3]]]],
                    dtype=np.int32)


def auto_wb_multipliers(cfa: np.ndarray, pattern: str, *,
                        maximum: int = 65535,
                        black: int = 0) -> np.ndarray:
    """dcraw's automatic white balance (scale_colors' use_auto_wb
    branch): 8x8 blocks fully below ``maximum - 25`` contribute
    per-channel sums of ``max(val - black, 0)``; ``pre_mul[c] =
    count[c] / sum[c]``.  Blocks only start at rows/cols < dim-7.

    Returns the 4-vector pre_mul (second green = 0 here, fixed up by
    :func:`scale_multipliers` like dcraw)."""
    h, w = cfa.shape
    ch = _channel_map(pattern)
    # dcraw iterates row in range(0, height-7, 8): full blocks only
    nby = len(range(0, h - 7, 8))
    nbx = len(range(0, w - 7, 8))
    if nby == 0 or nbx == 0:
        return np.ones(4)
    blk = cfa[: nby * 8, : nbx * 8].astype(np.int64)
    blk = blk.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)  # (by,bx,8,8)
    keep = ~(blk > maximum - 25).any(axis=(2, 3))            # skip_block
    # channel of absolute position (by*8+y, bx*8+x): block origins are
    # multiples of 8 (even), so one (8, 8) parity map covers all blocks
    chan = ch[np.arange(8)[:, None] % 2, np.arange(8)[None, :] % 2]
    vals = np.maximum(blk - black, 0)
    sums = np.zeros(4)
    cnts = np.zeros(4)
    for c in range(3):
        m = chan == c
        sums[c] = vals[keep][:, m].sum()
        cnts[c] = keep.sum() * int(m.sum())
    pre = np.ones(4)
    for c in range(4):
        if sums[c]:
            pre[c] = cnts[c] / sums[c]
    pre[3] = 0.0  # unused second green, like the filters-based scan
    return pre


def choose_multipliers(*, user_mul: Optional[Sequence[float]] = None,
                       use_camera_wb: bool = False,
                       use_auto_wb: bool = False,
                       cam_mul: Optional[Sequence[float]] = None,
                       cfa: Optional[np.ndarray] = None,
                       pattern: str = "RGGB", maximum: int = 65535,
                       black: int = 0) -> np.ndarray:
    """dcraw scale_colors' multiplier precedence:

    1. ``user_mul[0] != 0`` seeds pre_mul (the reference sets
       ``(mul[0], 1, mul[2], 1)`` when auto_mul is off,
       image_formats_libraries.c:699-704);
    2. ``use_auto_wb`` (or camera WB requested but no camera data)
       overwrites with the gray-world estimate;
    3. valid camera WB (``cam_mul[0] and cam_mul[2]`` nonzero)
       overwrites with cam_mul;
    4. otherwise the daylight pre_mul stands (no color tables exist
       offline, so daylight == all-ones here; a decoder that recovers
       camera neutral values may pass them as ``cam_mul``)."""
    pre = np.ones(4)
    if user_mul is not None and user_mul[0]:
        pre = np.asarray(list(user_mul) + [0.0] * (4 - len(user_mul)),
                         dtype=np.float64)[:4].copy()
    cam_ok = cam_mul is not None and cam_mul[0] != -1
    if use_auto_wb or (use_camera_wb and not cam_ok):
        if cfa is None:
            raise ValueError("auto WB needs the CFA plane")
        pre = auto_wb_multipliers(cfa, pattern, maximum=maximum,
                                  black=black)
    if use_camera_wb and cam_ok:
        cm = np.asarray(cam_mul, dtype=np.float64)
        if cm[0] and cm[2]:
            pre = np.concatenate([cm, np.zeros(4)])[:4].copy()
        # else: "Cannot use camera white balance" — keep pre
    return pre


def scale_multipliers(pre_mul: np.ndarray, *, maximum: int = 65535,
                      black: int = 0) -> np.ndarray:
    """Normalize pre_mul and build scale_mul like dcraw scale_colors:
    zero greens fixed up, all divided by the minimum (highlight=0 =>
    dmax=dmin), times ``65535 / (maximum - black)``."""
    pre = np.asarray(pre_mul, dtype=np.float64).copy()
    if pre[1] == 0:
        pre[1] = 1.0
    if pre[3] == 0:
        pre[3] = pre[1]
    dmin = pre.min()
    eff_max = maximum - black
    return (pre / dmin) * 65535.0 / eff_max


def scale_cfa(cfa: np.ndarray, pattern: str, scale_mul: np.ndarray, *,
              black: int = 0) -> np.ndarray:
    """Apply black subtraction + per-channel scaling to the CFA plane:
    ``CLIP(trunc((val - black) * scale_mul[c]))`` (dcraw scale_colors'
    final loop; int truncation toward zero, clip to [0, 65535]).
    Zero samples stay zero (dcraw's ``if (!val) continue``)."""
    h, w = cfa.shape
    ch = _channel_map(pattern)
    chan = ch[np.arange(h)[:, None] % 2, np.arange(w)[None, :] % 2]
    mul = np.asarray(scale_mul, dtype=np.float64)[chan]
    v = cfa.astype(np.float64)
    out = np.trunc((v - black) * mul)
    out = np.clip(out, 0, 65535)
    out[cfa == 0] = 0
    return out.astype(np.uint16)


def gamma_curve(pwr: float, ts: float, imax: float) -> np.ndarray:
    """dcraw's ``gamma_curve(pwr, ts, 2, imax)`` LUT (mode 2 = the
    forward curve applied on output): 0x10000 uint16 entries.  The
    toe/knee split point g[3] comes from a 48-step bisection exactly as
    in the C. The reference calls this with ``pwr = 1/raw_set.gamm[0]``,
    ``ts = raw_set.gamm[1]``, ``imax = (0x2000 << 3) / bright``
    (no_auto_bright keeps the white point at 0x2000)."""
    g = [pwr, ts, 0.0, 0.0, 0.0]
    bnd = [0.0, 0.0]
    bnd[1 if g[1] >= 1 else 0] = 1.0
    if g[1] and (g[1] - 1) * (g[0] - 1) <= 0:
        for _ in range(48):
            g[2] = (bnd[0] + bnd[1]) / 2
            if g[0]:
                t = (math.pow(g[2] / g[1], -g[0]) - 1) / g[0] - 1 / g[2]
                bnd[1 if t > -1 else 0] = g[2]
            else:
                bnd[1 if g[2] / math.exp(1 - 1 / g[2]) < g[1] else 0] = g[2]
        g[3] = g[2] / g[1]
        if g[0]:
            g[4] = g[2] * (1 / g[0] - 1)
    i = np.arange(0x10000, dtype=np.float64)
    r = i / imax
    if g[0]:
        hi = np.power(np.maximum(r, 1e-300), g[0]) * (1 + g[4]) - g[4]
    else:
        hi = np.log(np.maximum(r, 1e-300)) * g[2] + 1
    y = np.where(r < g[3], r * g[1], hi)
    curve = np.where(r < 1, np.trunc(65536.0 * y), 65535.0)
    return np.clip(curve, 0, 65535).astype(np.uint16)


def output_curve(gamm0: float, gamm1: float, bright: float) -> np.ndarray:
    """The output LUT for the reference's knob mapping
    (image_formats_libraries.c:688-690): user gamma pair + brightness,
    under no_auto_bright (white point 0x2000)."""
    return gamma_curve(1.0 / gamm0, gamm1, (0x2000 << 3) / bright)


def postprocess_cfa(cfa: np.ndarray, pattern: str, settings, *,
                    cam_mul: Optional[Sequence[float]] = None,
                    maximum: int = 65535,
                    black: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 1+3 of the readraw pipeline for a top-down CFA plane:
    returns (scaled_cfa, output_lut).  The caller demosaics the scaled
    CFA and maps the result through the LUT.  ``settings`` is a
    :class:`siriltpu_torch.core.config.Settings`; ``raw_user_black`` forces
    the black level to 0 like the reference's dcraw -k 0 mapping."""
    if settings.raw_user_black:
        black = 0
    user_mul = (None if settings.raw_auto_mul else
                (settings.raw_mul_0, 1.0, settings.raw_mul_2, 1.0))
    pre = choose_multipliers(
        user_mul=user_mul, use_camera_wb=bool(settings.raw_cam_wb),
        use_auto_wb=bool(settings.raw_auto_wb), cam_mul=cam_mul,
        cfa=cfa, pattern=pattern, maximum=maximum, black=black)
    smul = scale_multipliers(pre, maximum=maximum, black=black)
    scaled = scale_cfa(cfa, pattern, smul, black=black)
    lut = output_curve(settings.raw_gamm_0, settings.raw_gamm_1,
                       settings.raw_bright)
    return scaled, lut


#: reference user_qual -> siriltpu demosaic method
#: (image_formats_libraries.c:706-732 maps 0->bilinear, 2->VNG, 3->PPG,
#: 1/default->AHD; PPG is not implemented here and maps to VNG — see
#: PARITY.md)
USER_QUAL_METHODS = {0: "bilinear", 1: "ahd", 2: "vng", 3: "vng"}


__all__ = ["auto_wb_multipliers", "choose_multipliers",
           "scale_multipliers", "scale_cfa", "gamma_curve",
           "output_curve", "postprocess_cfa", "USER_QUAL_METHODS"]
