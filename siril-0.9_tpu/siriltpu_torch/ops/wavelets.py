"""À-trous ("pavé") undecimated wavelet transform.

Port of ``siriltpu.ops.wavelets``. Reference: src/algos/pave.c — linear
smoothing kernel [1/4,1/2,1/4]² (``pave_2d_linear_smooth`` :106-136),
B3-spline kernel [1/16,4/16,6/16,4/16,1/16]² (``pave_2d_bspline_smooth``
:227-286), transform ``pave_2d_tfo`` (:140-187: plane_k = img_k −
smooth_k(img_k), last plane = final smooth), reconstruction with per-plane
weights (``pave_2d_build`` :191-210), plane extraction (:214-227).

Border handling reproduces ``test_ind`` (pave.c:88-102) as COMPILED,
verified against the C binary in tests/test_c_goldens.py: any negative
index is pinned to 0 (the mirror ``Val = -ind`` is commented out; the
live statement is ``Val = -0``), and an index ≥ N is pinned to N−1 —
i.e. both edges clamp to the boundary pixel.

Step for plane k is 2^k; the smoothing is separable, two 1-D passes of
shifted taps summed in a fixed order, each product and each sum one
float32 operation (no fused multiply-add), so the planes equal the JAX
package's bit for bit.

Used by: the ``wavelet``/``wrecons`` commands (src/core/command.c:443-530)
and the star finder, which runs a 3-plane B-spline transform and takes
plane 2 — i.e. the twice-smoothed image (star_finder.c:141,
core/siril.c:1285).
"""

from __future__ import annotations

import numpy as np
import torch

from siriltpu_torch.utils.interop import to_float32
from siriltpu_torch.utils.rounding import np_round_to_word

Tensor = torch.Tensor

TO_PAVE_LINEAR = 1
TO_PAVE_BSPLINE = 2

_LINEAR_TAPS = ((-1, 0.25), (0, 0.5), (1, 0.25))
_BSPLINE_TAPS = ((-2, 1.0 / 16), (-1, 4.0 / 16), (0, 6.0 / 16),
                 (1, 4.0 / 16), (2, 1.0 / 16))


def _shift_take(img: Tensor, k: int, axis: int) -> Tensor:
    """out[i] = img[test_ind(i + k)] along ``axis`` (pave.c:88-102, the
    compiled rule: both edges clamp to the boundary pixel).
    k < 0: the first element repeated, then img[:n+k]
    k > 0: img[k:], then the last element repeated."""
    if k == 0:
        return img
    n = img.shape[axis]
    shape = list(img.shape)
    shape[axis] = abs(k)
    if k < 0:
        head = img.narrow(axis, 0, 1).expand(shape)
        return torch.cat([head, img.narrow(axis, 0, n + k)], dim=axis)
    tail = img.narrow(axis, n - 1, 1).expand(shape)
    return torch.cat([img.narrow(axis, k, n - k), tail], dim=axis)


def _smooth_1d(img: Tensor, taps, step: int, axis: int) -> Tensor:
    out = torch.zeros_like(img)
    for off, w in taps:
        out = out + w * _shift_take(img, off * step, axis)
    return out


def atrous_smooth(img: Tensor, plane: int, kind: int = TO_PAVE_BSPLINE) -> Tensor:
    """One smoothing pass at scale ``plane`` (step 2^plane) over the last
    two axes."""
    step = int(round(2.0 ** plane))
    taps = _BSPLINE_TAPS if kind == TO_PAVE_BSPLINE else _LINEAR_TAPS
    out = _smooth_1d(img, taps, step, axis=-2)
    return _smooth_1d(out, taps, step, axis=-1)


def atrous_transform(img: Tensor, nplanes: int, kind: int = TO_PAVE_BSPLINE
                     ) -> Tensor:
    """Full transform of a (H, W) tensor: returns (nplanes, H, W) float32,
    detail planes 0..nplanes-2 and the residual smooth as the last
    plane."""
    cur = to_float32(img)
    planes = []
    for k in range(nplanes - 1):
        sm = atrous_smooth(cur, k, kind)
        planes.append(cur - sm)
        cur = sm
    planes.append(cur)
    return torch.stack(planes)


def atrous_reconstruct(planes: Tensor, weights: Tensor) -> Tensor:
    """Weighted reconstruction (pave_2d_build): sum(w_k * plane_k)."""
    return torch.tensordot(weights.to(torch.float32), planes, dims=1)


def wavelet_plane_word(layer: np.ndarray, nplanes: int, plane: int,
                       kind: int = TO_PAVE_BSPLINE, *, device) -> np.ndarray:
    """``get_wavelet_layers`` equivalent (core/siril.c:1285-1337): extract
    one plane of the transform of a uint16 layer, computed on ``device``,
    and convert back to WORD.

    ``reget_rawdata`` (reconstr.c:120-139) rescales by 65535/max if the
    max exceeds 65535, then round_to_WORD (negatives clamp to 0)."""
    layer = np.ascontiguousarray(layer)
    if layer.dtype == np.uint16:
        layer = layer.astype(np.int32)
    tr = atrous_transform(torch.from_numpy(layer).to(device), nplanes, kind)
    p = tr[plane].cpu().numpy().astype(np.float64)
    mx = p.max() if p.size else 0.0
    ratio = 65535.0 / mx if mx > 65535.0 else 1.0
    return np_round_to_word(p * ratio)


def max_nplanes(rx: int, ry: int) -> int:
    """Wavelet plan limit: log2(min(rx, ry)) - 2 (command.c:1506-1512)."""
    return int(np.log2(min(rx, ry))) - 2


__all__ = ["atrous_transform", "atrous_reconstruct", "atrous_smooth",
           "wavelet_plane_word", "max_nplanes", "TO_PAVE_LINEAR",
           "TO_PAVE_BSPLINE"]
