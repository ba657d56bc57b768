"""RGB(+L) layer compositing.

Port of ``siriltpu.pipelines.compositing``: ``compose`` and
``wavelength_to_color`` are host NumPy, copied; ``align_layers`` and
``align_rgb`` register on ``device``.

Reference: src/compositing/compositing.c — up to 8 mono layers
(MAX_LAYERS :58) each with an assigned color (including wavelength →
color filters, filters.c); composition = per-pixel sum of
color-weighted normalized layer values, clamped per component
(``rgb_pixel_limiter``); optional luminance layer replaces the
L/V/L* component in HSL/HSV/CIELAB space (``coloring_type_enum``
:47-53, ``luminance_and_colors_align_and_compose`` :756-830).

Inter-layer alignment reuses any registration method over an internal
sequence (compositing.c register path); ``align_rgb`` aligns the three
channels of one RGB image the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame, Rect
from siriltpu_torch.ops import colors as C
from siriltpu_torch.utils.rounding import np_round_to_word

MAX_LAYERS = 8

HSL = "hsl"
HSV = "hsv"
CIELAB = "lab"


# wavelength -> RGB color (filters.c narrowband presets)
FILTER_COLORS = {
    "Ha": (1.0, 0.0, 0.0),        # 656 nm
    "SII": (0.55, 0.0, 0.0),      # 672 nm deep red
    "OIII": (0.0, 1.0, 0.75),     # 501 nm teal
    "Hb": (0.0, 0.5, 1.0),        # 486 nm
    "R": (1.0, 0.0, 0.0),
    "G": (0.0, 1.0, 0.0),
    "B": (0.0, 0.0, 1.0),
}


def wavelength_to_color(nm: float) -> Tuple[float, float, float]:
    """Approximate visible-spectrum wavelength to RGB (filters.c)."""
    w = float(nm)
    if w < 380 or w > 780:
        return (0.5, 0.5, 0.5)
    if w < 440:
        r, g, b = -(w - 440) / 60.0, 0.0, 1.0
    elif w < 490:
        r, g, b = 0.0, (w - 440) / 50.0, 1.0
    elif w < 510:
        r, g, b = 0.0, 1.0, -(w - 510) / 20.0
    elif w < 580:
        r, g, b = (w - 510) / 70.0, 1.0, 0.0
    elif w < 645:
        r, g, b = 1.0, -(w - 645) / 65.0, 0.0
    else:
        r, g, b = 1.0, 0.0, 0.0
    return (max(r, 0.0), max(g, 0.0), max(b, 0.0))


@dataclass
class CompositionLayer:
    frame: Frame
    color: Tuple[float, float, float]  # RGB in [0,1]


def align_layers(layers: List[Frame], method: str = "dft",
                 selection: Optional[Rect] = None, *, device) -> List[Frame]:
    """Inter-layer alignment via an internal sequence and any
    registration method, run on ``device``; returns shifted copies
    (first layer = reference)."""
    from siriltpu_torch.io.sequence import internal_sequence
    from siriltpu_torch.registration.translation import register_shift_dft
    from siriltpu_torch.registration.onestar import register_onestar
    from siriltpu_torch.verify.oracle import shift_gather

    seq = internal_sequence(layers, name="composition")
    if method == "dft":
        if selection is None:
            s = min(min(l.rx for l in layers), min(l.ry for l in layers))
            s = 1 << (s.bit_length() - 1)
            selection = Rect((layers[0].rx - s) // 2,
                             (layers[0].ry - s) // 2, s, s)
        register_shift_dft(seq, 0, selection, device=device)
    elif method == "onestar":
        if selection is None:
            raise ValueError("one-star alignment needs a selection")
        register_onestar(seq, 0, selection, device=device)
    else:
        raise ValueError(f"unknown alignment method {method}")
    shifts = seq.reg_shifts(0)
    out = []
    for i, l in enumerate(layers):
        data = shift_gather(l.data, int(shifts[i, 0]), int(shifts[i, 1]),
                            fill=0, skip_origin=False)
        out.append(Frame(data, dict(l.meta)))
    return out


def compose(color_layers: Sequence[CompositionLayer],
            luminance: Optional[Frame] = None,
            coloring: str = HSL) -> Frame:
    """Compose mono layers into one RGB frame.

    Per pixel: rgb = clamp(sum_k color_k * value_k / 65535); when a
    luminance layer is given, the lightness component is replaced in the
    chosen colorspace (compositing.c:756-830).
    """
    if not color_layers and luminance is None:
        raise ValueError("no layers to compose")
    if not color_layers:
        data = np.repeat(luminance.data[:1], 3, axis=0)
        return Frame(data.copy())
    h, w = color_layers[0].frame.ry, color_layers[0].frame.rx
    acc = np.zeros((3, h, w), dtype=np.float64)
    for lay in color_layers[:MAX_LAYERS]:
        v = lay.frame.data[0].astype(np.float64) / 65535.0
        for c in range(3):
            acc[c] += lay.color[c] * v
    acc = np.clip(acc, 0.0, 1.0)  # rgb_pixel_limiter

    if luminance is not None:
        norm = max(float(luminance.data.max()), 1.0)
        lum = luminance.data[0].astype(np.float64) / norm
        r, g, b = acc[0], acc[1], acc[2]
        if coloring == HSL:
            hh, ss, _ = C.rgb_to_hsl(r, g, b)
            r, g, b = C.hsl_to_rgb(hh, ss, lum)
        elif coloring == HSV:
            hh, ss, _ = C.rgb_to_hsv(r, g, b)
            r, g, b = C.hsv_to_rgb(hh, ss, lum)
        elif coloring == CIELAB:
            x, y, z = C.rgb_to_xyz(r, g, b)
            _, a2, b2 = C.xyz_to_lab(x, y, z)
            x, y, z = C.lab_to_xyz(lum * 100.0, a2, b2)
            r, g, b = C.xyz_to_rgb(x, y, z)
            r, g, b = np.clip(r, 0, 1), np.clip(g, 0, 1), np.clip(b, 0, 1)
        else:
            raise ValueError(f"unknown coloring {coloring}")
        acc = np.stack([r, g, b])

    return Frame(np.stack([np_round_to_word(acc[c] * 65535.0)
                           for c in range(3)]))


def align_rgb(frame: Frame, method: str = "dft",
              selection: Optional[Rect] = None, *, device) -> Frame:
    """Align the three channels of one RGB image (align_rgb.c), the
    registration on ``device``."""
    if frame.nlayers != 3:
        raise ValueError("align_rgb needs an RGB image")
    layers = [Frame(frame.data[c : c + 1].copy()) for c in range(3)]
    aligned = align_layers(layers, method, selection, device=device)
    return Frame(np.concatenate([a.data for a in aligned]), dict(frame.meta))


__all__ = ["compose", "align_layers", "align_rgb", "CompositionLayer",
           "wavelength_to_color", "FILTER_COLORS", "HSL", "HSV", "CIELAB",
           "MAX_LAYERS"]
