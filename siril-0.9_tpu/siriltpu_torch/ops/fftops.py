"""FFTD / FFTI commands: forward DFT to modulus+phase images and inverse.

Port of ``siriltpu.ops.fftops``: host NumPy (pocketfft) float64, copied
without change. The transforms stay on the host: cuFFT's float64 sums
round differently, and the rounding of modulus and phase to words would
move words on .5 knife edges.

Reference: src/algos/fft.c. Quirks preserved:

- the reference passes (width, height) to fftw_plan_dft_2d, which expects
  (rows, cols) — i.e. the buffer is transformed as a (rx, ry) matrix.
  We reshape accordingly (identical for square images);
- modulus normalized by its max to 65535 (norm stored in the FITS header
  as DFTNORMn), phase mapped from [-pi, pi] to [0, 65535] (:95-107);
- CENTERED order swaps quadrants (``change_symmetry`` :59-79).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame
from siriltpu_torch.utils.rounding import np_round_to_word


def _fftshift_like(a: np.ndarray) -> np.ndarray:
    """change_symmetry quadrant swap (integer halves, like the C code)."""
    h, w = a.shape
    out = np.empty_like(a)
    h2, w2 = h // 2, w // 2
    out[:h - h2, :w - w2] = a[h2:, w2:]
    out[:h - h2, w - w2:] = a[h2:, :w2]
    out[h - h2:, :w - w2] = a[:h2, w2:]
    out[h - h2:, w - w2:] = a[:h2, :w2]
    return out


def fftd(frame: Frame, type_order: str = "centered"
         ) -> Tuple[Frame, Frame]:
    """Forward DFT -> (modulus frame, phase frame) with header metadata
    (FFTD, fft.c:119-165)."""
    c, h, w = frame.data.shape
    mod_out = np.empty_like(frame.data)
    pha_out = np.empty_like(frame.data)
    norms = []
    centered = type_order.lower().startswith("c")
    for ch in range(c):
        buf = frame.data[ch].reshape(-1).astype(np.float64)
        # reference FFTW dims are (rx, ry): transform the (w, h) view
        mat = buf.reshape(w, h)
        fr = np.fft.fft2(mat)
        modulus = np.abs(fr).reshape(-1)
        phase = np.arctan2(fr.imag, fr.real).reshape(-1)
        max_m = modulus.max()
        mod_img = modulus.reshape(h, w)
        pha_img = phase.reshape(h, w)
        if centered:
            mod_img = _fftshift_like(mod_img)
            pha_img = _fftshift_like(pha_img)
        pha_out[ch] = np_round_to_word((pha_img + np.pi) * 65535.0 /
                                       (2 * np.pi))
        mod_out[ch] = np_round_to_word(mod_img * 65535.0 / max(max_m, 1e-30))
        norms.append(max_m / 65535.0)
    order = "CENTERED" if centered else "REGULAR"
    meta_m = {"dft_type": "SPECTRUM", "dft_ord": order, "dft_norm": norms,
              "dft_rx": w, "dft_ry": h}
    meta_p = {"dft_type": "PHASE", "dft_ord": order, "dft_norm": norms,
              "dft_rx": w, "dft_ry": h}
    return Frame(mod_out, meta_m), Frame(pha_out, meta_p)


def ffti(modulus: Frame, phase: Frame) -> Frame:
    """Inverse DFT from modulus+phase images (FFTI, fft.c:167-230)."""
    c, h, w = modulus.data.shape
    out = np.empty_like(modulus.data)
    norms = modulus.meta.get("dft_norm") or [1.0] * c
    centered = str(modulus.meta.get("dft_ord", "")).upper().startswith("C")
    for ch in range(c):
        norm = float(norms[ch] if norms[ch] is not None else 1.0)
        mod_img = modulus.data[ch].astype(np.float64)
        pha_img = phase.data[ch].astype(np.float64)
        if centered:
            mod_img = _fftshift_like(mod_img)
            pha_img = _fftshift_like(pha_img)
        mod = mod_img.reshape(-1) * norm
        pha = pha_img.reshape(-1) * (2 * np.pi) / 65535.0 - np.pi
        fr = (mod * (np.cos(pha) + 1j * np.sin(pha))).reshape(w, h)
        spatial = np.fft.ifft2(fr).real.reshape(-1)
        out[ch] = np_round_to_word(spatial.reshape(h, w))
    return Frame(out)


__all__ = ["fftd", "ffti"]
