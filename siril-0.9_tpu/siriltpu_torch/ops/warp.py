"""Perspective / affine image warping with OpenCV-compatible
interpolation kernels — the geometric engine of global star alignment.

Port of ``siriltpu.ops.warp``. Reference: ``cvTransformImage``
(src/opencv/opencv.cpp:242-309) = ``warpPerspective(in, out, H, size,
interpolation)`` applied to the top-down-flipped image
(registration.c:720-722 flips, warps, flips back because the rotation
center is at (0,0) in the star coordinate frame).

Semantics: dst(x, y) = src(H^{-1} · (x, y, 1)), constant-0 border.
Interpolations: nearest, linear (bilinear), cubic (Keys, A = -0.75),
lanczos4 (normalized sinc(d)·sinc(d/4), 8-tap, weight-exact against
OpenCV 4.6, tests/goldens/c_cvgeom.bin); OpenCV's warpPerspective /
warpAffine remap INTER_AREA to linear. OpenCV quantizes warp sample
coordinates to 1/32 px (INTER_BITS); we compute in float32.

Every entry point samples by gather, tap by tap, in the JAX package's
order of float32 operations. The JAX package's tiled banded sampler
(``_warp_perspective_tiled``, ``_tiled_plan``) exists only because the
TPU has no vector gather, and is not ported. The image is padded with
one row and column of zeros on each side and tap coordinates are clamped
into the pad, so a tap outside the image reads 0 without a mask; the
coordinates are clamped as floats before the cast to int32, so a wild
homography gives the same result on every device. Frames are warped one
layer at a time, which bounds the float32 temporaries by one layer's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from siriltpu_torch.utils.interop import frames_from_numpy, i32_to_u16, to_float32

Tensor = torch.Tensor

# Interpolation values are API surface: the reference passes its
# config/GUI integer VERBATIM into cv::resize / warpAffine /
# warpPerspective (opencv.cpp:89,153,262), so at runtime the values
# mean what OpenCV's real InterpolationFlags enum says they mean:
#   0 nearest, 1 linear, 2 CUBIC, 3 AREA, 4 lanczos4.
# The reference's own enum NAMES (siril.h:257-264 "OPENCV_AREA = 2,
# OPENCV_CUBIC = 3") are swapped relative to OpenCV and therefore lie:
# a Siril 0.9 user selecting the GUI item wired to value 2 ("Area")
# actually gets bicubic, and value 3 ("Cubic") actually gets
# area-resample in resize / bilinear in warps. We reproduce the
# OBSERVABLE behavior (what the linked OpenCV executes), not the
# header's mislabels — see PARITY.md "interpolation enum" and the
# real-OpenCV golden suite (tests/goldens/c_cvgeom.bin).
INTER_NEAREST = 0   # cv::INTER_NEAREST
INTER_LINEAR = 1    # cv::INTER_LINEAR
INTER_CUBIC = 2     # cv::INTER_CUBIC   (siril.h mislabels 2 "OPENCV_AREA")
INTER_AREA = 3      # cv::INTER_AREA    (siril.h mislabels 3 "OPENCV_CUBIC")
INTER_LANCZOS4 = 4  # cv::INTER_LANCZOS4

_CUBIC_A = -0.75


def _cubic_weights(t: Tensor):
    """OpenCV interpolateCubic with A = -0.75; t in [0,1)."""
    A = _CUBIC_A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    u = 1.0 - t
    w2 = ((A + 2) * u - (A + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


def _lanczos4_weights(t: Tensor):
    """Normalized Lanczos-4 windowed sinc, sinc(d)·sinc(d/4) over taps
    at distances d = t+3-i, i = 0..7 — OpenCV interpolateLanczos4's
    kernel (c_cvgeom goldens)."""
    ws = []
    total = None
    for i in range(8):
        d = t + (3 - i)
        x = torch.where(d.abs() < 1e-7, 1e-7, d) * math.pi
        w = (torch.sin(x) / x) * (torch.sin(x * 0.25) / (x * 0.25))
        ws.append(w)
        total = w if total is None else total + w
    ws = [w / total for w in ws]
    # exact-integer coordinate: delta function on tap 3
    exact = t < 1e-7
    return [torch.where(exact, 1.0 if i == 3 else 0.0, w) for i, w in enumerate(ws)]


def _tap_rows(y0: Tensor, h: int, w: int, offs):
    """Flat offsets into the zero-padded (h + 2, w + 2) image of the rows
    ``y0 + off``, clamped into the pad."""
    return [(torch.clamp(y0 + off, -1, h) + 1) * (w + 2) for off in offs]


def _tap_cols(x0: Tensor, w: int, offs):
    return [torch.clamp(x0 + off, -1, w) + 1 for off in offs]


def _to_index(v: Tensor, size: int) -> Tensor:
    """floor'ed float coordinates -> int32, clamped first to a range where
    every tap of every kernel falls outside [0, size) exactly when it did
    before the clamp."""
    return torch.clamp(v, -16.0, float(size + 16)).to(torch.int32)


def _interp(img: Tensor, xs: Tensor, ys: Tensor, interpolation: int) -> Tensor:
    if interpolation == INTER_AREA:
        # cv::warpPerspective / warpAffine have no AREA path and fall
        # back to INTER_LINEAR (OpenCV remap semantics)
        interpolation = INTER_LINEAR
    h, w = img.shape
    flat = torch.nn.functional.pad(img, (1, 1, 1, 1)).reshape(-1)

    def gather(idx: Tensor) -> Tensor:
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    if interpolation == INTER_NEAREST:
        xi = _to_index(torch.floor(xs + 0.5), w)
        yi = _to_index(torch.floor(ys + 0.5), h)
        return gather(_tap_rows(yi, h, w, (0,))[0] + _tap_cols(xi, w, (0,))[0])
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    if interpolation == INTER_LINEAR:
        wx = [1.0 - fx, fx]
        wy = [1.0 - fy, fy]
        offs = (0, 1)
    elif interpolation == INTER_CUBIC:
        wx = _cubic_weights(fx)
        wy = _cubic_weights(fy)
        offs = (-1, 0, 1, 2)
    elif interpolation == INTER_LANCZOS4:
        wx = _lanczos4_weights(fx)
        wy = _lanczos4_weights(fy)
        offs = tuple(range(-3, 5))
    else:
        raise ValueError(f"unknown interpolation {interpolation}")
    rows = _tap_rows(_to_index(y0, h), h, w, offs)
    cols = _tap_cols(_to_index(x0, w), w, offs)
    out = None
    for dy in range(len(offs)):
        row = None
        for dx in range(len(offs)):
            term = wx[dx] * gather(rows[dy] + cols[dx])
            row = term if row is None else row + term
        term = wy[dy] * row
        out = term if out is None else out + term
    return out


def warp_perspective(img: Tensor, H_inv: Tensor, out_shape: Tuple[int, int],
                     interpolation: int = INTER_LINEAR) -> Tensor:
    """dst(x,y) = img(H_inv @ (x,y,1)), constant-0 border, float32 out, on
    the device of ``img``; ``H_inv`` is a (3, 3) float32 tensor there."""
    oh, ow = out_shape
    dev = img.device
    yy = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(oh, ow)
    xx = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(oh, ow)
    w = H_inv[2, 0] * xx + H_inv[2, 1] * yy + H_inv[2, 2]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    xs = (H_inv[0, 0] * xx + H_inv[0, 1] * yy + H_inv[0, 2]) / w
    ys = (H_inv[1, 0] * xx + H_inv[1, 1] * yy + H_inv[1, 2]) / w
    return _interp(to_float32(img), xs, ys, interpolation)


def _h_inv(H_td, device) -> Tensor:
    """(…, 3, 3) inverse homographies, inverted in f64 on the host, as a
    float32 tensor on ``device``."""
    Hinv = np.linalg.inv(np.asarray(H_td, dtype=np.float64))
    return torch.from_numpy(Hinv.astype(np.float32)).to(device)


def _warp_layer(layer_bu: Tensor, Hinv: Tensor, out_shape, interpolation) -> Tensor:
    """One bottom-up uint16 layer -> bottom-up uint16, rounded as OpenCV's
    saturate_cast: round to nearest even, then clamp."""
    td = layer_bu.view(torch.int16).flip(0).view(torch.uint16)
    warped = warp_perspective(td, Hinv, out_shape, interpolation)
    word = i32_to_u16(torch.clamp(torch.round(warped), 0, 65535).to(torch.int32))
    return word.view(torch.int16).flip(0).view(torch.uint16)


def warp_frame_bu(data_bu: np.ndarray, H_td: np.ndarray,
                  out_shape: Tuple[int, int],
                  interpolation: int = INTER_LINEAR, *, device) -> np.ndarray:
    """Warp a bottom-up (C, H, W) uint16 frame by a homography expressed
    in TOP-DOWN star coordinates (cvTransformImage + surrounding flips,
    registration.c:720-722), on ``device``. Returns uint16 (C, oh, ow)
    bottom-up, on the host."""
    dev = frames_from_numpy(np.asarray(data_bu), device)
    out = warp_frame_dev(dev, H_td, out_shape, interpolation)
    return out.view(torch.int16).cpu().numpy().view(np.uint16)


def warp_layer_dev(layer_dev_bu: Tensor, H_td: np.ndarray,
                   out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR) -> Tensor:
    """Single-layer warp of a bottom-up uint16 layer already on its
    device (the star finder's copy): the flips, the rounding and the
    uint16 store stay there. Returns an (oh, ow) uint16 tensor."""
    return _warp_layer(layer_dev_bu, _h_inv(H_td, layer_dev_bu.device),
                       tuple(out_shape), interpolation)


def warp_frame_dev(frame_dev_bu: Tensor, H_td: np.ndarray,
                   out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR) -> Tensor:
    """All-channel warp of a (C, H, W) uint16 tensor: (C, oh, ow) uint16 on
    its device, one layer at a time."""
    Hinv = _h_inv(H_td, frame_dev_bu.device)
    return torch.stack([_warp_layer(layer, Hinv, tuple(out_shape), interpolation)
                        for layer in frame_dev_bu])


def warp_batch_dev(layers_bu, Hs_td: np.ndarray, out_shape: Tuple[int, int],
                   interpolation: int = INTER_LINEAR, *, device, mesh=None) -> Tensor:
    """Frame-batched warp: (F, H, W) uint16 layers (NumPy, or a tensor)
    with per-frame 3x3 homographies (F, 3, 3) -> (F, oh, ow) uint16 on
    ``device``, one layer at a time, as the JAX package's ``lax.map``.
    With ``mesh`` (``parallel.mesh``) the frame axis shards over it: each
    entry's device warps its own frames with the same per-frame body (no
    collective, bit-identical to unsharded), and the result is gathered
    on ``device``."""
    if mesh is not None:
        from siriltpu_torch.parallel.mesh import run_frames_sharded

        # the inverses cross (zero-padded, as in the JAX package): a
        # padded frame's zero homography has none
        return run_frames_sharded(
            lambda layers, hinvs: _warp_batch(layers, hinvs, out_shape,
                                              interpolation),
            mesh, layers_bu, _h_inv(Hs_td, "cpu"), out_device=device)
    if not isinstance(layers_bu, Tensor):
        layers_bu = frames_from_numpy(np.asarray(layers_bu), device)
    layers_bu = layers_bu.to(device)
    return _warp_batch(layers_bu, _h_inv(Hs_td, device), out_shape, interpolation)


def _warp_batch(layers_bu: Tensor, Hinvs: Tensor, out_shape, interpolation) -> Tensor:
    """Each (H, W) uint16 layer warped by its float32 inverse homography,
    on the layers' device."""
    out = torch.empty((layers_bu.shape[0],) + tuple(out_shape), dtype=torch.int16,
                      device=layers_bu.device)
    for i in range(layers_bu.shape[0]):
        out[i] = _warp_layer(layers_bu[i], Hinvs[i], tuple(out_shape),
                             interpolation).view(torch.int16)
    return out.view(torch.uint16)


__all__ = ["warp_perspective", "warp_frame_bu", "warp_layer_dev",
           "warp_frame_dev", "warp_batch_dev", "INTER_NEAREST",
           "INTER_LINEAR", "INTER_AREA", "INTER_CUBIC", "INTER_LANCZOS4"]
