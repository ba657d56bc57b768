"""FFT phase cross-correlation shift registration (the "image pattern"
planetary registration method).

Port of ``siriltpu.ops.fftreg``. Reference: ``register_shift_dft``,
src/registration/registration.c:182-400. On a SQUARE selection, compute
FFT(ref) and per frame ``cross = FFT(ref) * conj(FFT(frame))``,
inverse-transform, take the argmax of the real part (first occurrence in
row-major order, registration.c:330-345) and decode (shifty, shiftx) =
divmod(idx, size), wrapping values > size/2 to negative (:346-353).

The transforms are ``torch.fft`` (cuFFT on the card), batched over all
frames. cuFFT rounds differently from XLA's FFT, so a near-tie of two
correlation peaks can decode to another shift; real shifted frames have
one clear peak.
"""

from __future__ import annotations

import numpy as np
import torch

from siriltpu_torch.utils.interop import to_float32


def _ref_fft(ref: torch.Tensor) -> torch.Tensor:
    # real-input transform: the cross-correlation of two real signals is
    # real, so the rfft/irfft round trip equals the C's complex transform
    # + real part (registration.c:330)
    return torch.fft.rfft2(to_float32(ref))


def _decode(idx: torch.Tensor, size: int):
    shifty = idx // size
    shiftx = idx % size
    shifty = torch.where(shifty > size // 2, shifty - size, shifty)
    shiftx = torch.where(shiftx > size // 2, shiftx - size, shiftx)
    return shiftx, shifty


def phase_correlate(ref_fft: torch.Tensor, frames: torch.Tensor):
    """Batched phase correlation.

    ref_fft: (S, S//2+1) complex64 (rfft2 of the reference selection).
    frames: (F, S, S) uint16/float. Returns (shiftx, shifty) int32 (F,).
    """
    size = frames.shape[-1]
    ffts = torch.fft.rfft2(to_float32(frames))
    cross = ref_fft[None] * torch.conj(ffts)
    corr = torch.fft.irfft2(cross, s=(size, size))
    # torch.argmax returns the first maximal index, like the C scan
    idx = torch.argmax(corr.reshape(corr.shape[0], -1), dim=1).to(torch.int32)
    return _decode(idx, size)


def decode_corr_peak(corr):
    """Decode (shiftx, shifty) from a real (S, S) correlation surface
    exactly like the reference scan (registration.c:337-354): the argmax
    and decode of :func:`phase_correlate`, on one surface. Takes a tensor
    or an array; returns Python ints."""
    if not isinstance(corr, torch.Tensor):
        corr = torch.from_numpy(np.array(corr))
    size = corr.shape[-1]
    idx = torch.argmax(corr.reshape(-1))
    shiftx, shifty = _decode(idx, size)
    return int(shiftx), int(shifty)


__all__ = ["phase_correlate", "decode_corr_peak"]
