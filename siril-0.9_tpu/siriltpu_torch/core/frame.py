"""Core containers: Frame, Rect, ImStats, RegData, ImgParam.

Port of ``siriltpu.core.frame``: plain NumPy dataclasses, copied without
change. They replace the reference's ``struct ffit``
(src/core/siril.h:391-442), ``imstats`` (src/core/siril.h:600-605),
``regdata`` (:316-326) and ``imgdata``.

Data conventions (frozen for bit-compatibility with Siril):

- Pixel type is ``uint16`` ("WORD", src/core/siril.h:44).
- Layout is channel-planar ``(C, H, W)``; mono images have C == 1.
- Row order is FITS file order, i.e. **bottom-to-top**: row index 0 is the
  bottom row of the sky image.
- Rectangles (selections, read regions) use **top-down** y coordinates like
  the reference GUI; conversion happens at the array boundary
  (``select_area``, src/algos/statistics.c:31-45).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

WORD_MAX = 65535
BYTE_MAX = 255


@dataclass(frozen=True)
class Rect:
    """A rectangle in top-down image coordinates (x right, y down from top).

    Mirrors the reference's ``rectangle`` type used for selections and
    partial reads (src/core/siril.h).
    """

    x: int
    y: int
    w: int
    h: int

    def __post_init__(self):
        if self.w < 0 or self.h < 0:
            raise ValueError(f"negative rectangle size: {self}")


@dataclass(frozen=True)
class ImStats:
    """Per-layer image statistics (reference ``imstats``, src/core/siril.h:600-605).

    All fields follow ``statistics()`` in src/algos/statistics.c:207-326:
    mean/sigma/bgnoise from the cfitsio-derived code (src/algos/quantize.c),
    median from a 65536-bin histogram, MAD likewise, BWMV and IKSS for stack
    normalization.
    """

    total: int = 0
    ngoodpix: int = 0
    mean: float = 0.0
    median: float = 0.0
    sigma: float = 0.0
    avgdev: float = 0.0
    mad: float = 0.0
    sqrtbwmv: float = 0.0
    bgnoise: float = 0.0
    min: float = 0.0
    max: float = 0.0
    location: float = 0.0
    scale: float = 0.0
    norm_value: float = float(WORD_MAX)
    layername: str = ""


@dataclass
class Frame:
    """One image: uint16, channel-planar, bottom-up rows.

    ``data`` has shape (C, H, W) with C in {1, 3}; header metadata lives in
    ``meta``.
    """

    data: np.ndarray
    # Selected header keys kept across operations (savefits writes them back,
    # src/io/image_format_fits.c:741-956).
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        a = np.asarray(self.data)
        if a.ndim == 2:
            a = a[None]
        if a.ndim != 3:
            raise ValueError(f"Frame data must be (C,H,W) or (H,W), got {a.shape}")
        if a.shape[0] not in (1, 3):
            raise ValueError(f"Frame must have 1 or 3 layers, got {a.shape[0]}")
        if a.dtype != np.uint16:
            raise ValueError(f"Frame data must be uint16, got {a.dtype}")
        self.data = a

    @property
    def nlayers(self) -> int:
        return self.data.shape[0]

    @property
    def ry(self) -> int:
        return self.data.shape[1]

    @property
    def rx(self) -> int:
        return self.data.shape[2]

    @property
    def exposure(self) -> float:
        return float(self.meta.get("exposure", 0.0))

    def layer(self, i: int) -> np.ndarray:
        return self.data[i]

    def copy(self) -> "Frame":
        return Frame(self.data.copy(), dict(self.meta))

    def with_data(self, data: np.ndarray) -> "Frame":
        return Frame(np.asarray(data, dtype=np.uint16), dict(self.meta))


def select_area(layer: np.ndarray, rect: Rect) -> np.ndarray:
    """Extract a top-down rectangle from a bottom-up layer.

    Matches ``select_area`` (src/algos/statistics.c:31-45): the returned
    array keeps the underlying (bottom-up) row order of the stored data
    within the selected rows.
    """
    ry = layer.shape[0]
    y0 = ry - rect.y - rect.h
    if y0 < 0 or rect.y < 0 or rect.x < 0 or rect.x + rect.w > layer.shape[1]:
        raise ValueError(f"selection {rect} out of bounds for layer {layer.shape}")
    return layer[y0 : y0 + rect.h, rect.x : rect.x + rect.w]


@dataclass
class RegData:
    """Per-frame registration data (reference ``regdata``, src/core/siril.h:316-326)."""

    shiftx: int = 0
    shifty: int = 0
    rot_centre_x: float = 0.0
    rot_centre_y: float = 0.0
    angle: float = 0.0
    fwhm: float = 0.0
    quality: float = -1.0


@dataclass
class ImgParam:
    """Per-image sequence bookkeeping (reference ``imgdata``)."""

    filenum: int = 0
    incl: bool = True
    stats: Optional[ImStats] = None
    date_obs: str = ""


__all__ = ["Frame", "ImStats", "Rect", "RegData", "ImgParam", "WORD_MAX",
           "BYTE_MAX", "select_area"]
