"""Synthetic ORF writer: an exact encoder for Olympus's compressed
bitstream plus a minimal ORF container (TIFF with the "RO" magic), for
round-trip validation of the native decode path (io/raw.read_orf_cfa +
native/olympus.cpp) without any camera file.

Unlike the quantizing Nikon post-split trees, every step of the
Olympus scheme is invertible: the encoder tracks the decoder's carry
state exactly and chooses sign/low/high fields that reconstruct each
pixel bit-for-bit, so round-trips compare against the planted image.

Port of ``siriltpu.testing.orf`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from siriltpu_torch.testing.cr2 import _ifd
from siriltpu_torch.testing.nef import _BitWriter


def _pred(img: np.ndarray, row: int, col: int) -> int:
    """The decoder's gradient-adaptive same-plane predictor."""
    if row < 2 and col < 2:
        return 0
    if row < 2:
        return int(img[row, col - 2])
    if col < 2:
        return int(img[row - 2, col])
    w = int(img[row, col - 2])
    n = int(img[row - 2, col])
    nw = int(img[row - 2, col - 2])
    if (w < nw < n) or (n < nw < w):
        if abs(w - nw) > 32 or abs(n - nw) > 32:
            return w + n - nw
        return (w + n) >> 1
    return w if abs(w - nw) > abs(n - nw) else n


def encode_olympus(img: np.ndarray) -> bytes:
    """Encode (H, W) uint16 values; exact (decoder recovers ``img``)."""
    img = np.asarray(img, np.int64)
    h, wd = img.shape
    bw = _BitWriter()
    for row in range(h):
        acarry = [[0, 0, 0], [0, 0, 0]]
        for col in range(wd):
            carry = acarry[col & 1]
            i = 2 * (carry[2] < 3)
            nbits = 2 + i
            while (carry[0] & 0xFFFF) >> (nbits + i):
                nbits += 1
            delta = int(img[row, col]) - _pred(img, row, col)
            low = delta & 3
            diff = delta >> 2
            t = diff - carry[1]
            if t >= 0:
                signbit, c0 = 0, t
            else:
                signbit, c0 = 1, ~t
            if c0 > 0xFFFF:
                raise ValueError(f"residual {t} not representable")
            high = c0 >> nbits
            bw.put((signbit << 2) | low, 3)
            if high < 12:
                bw.put(1, high + 1)  # unary: `high` zeros then a one
            else:
                if high >= 1 << (15 - nbits):
                    raise ValueError(f"escape high {high} overflows")
                bw.put(0, 12)
                bw.put(high << 1, 16 - nbits)
            bw.put(c0 & ((1 << nbits) - 1), nbits)
            carry[0] = c0
            carry[1] = (diff * 3 + carry[1]) >> 5
            carry[2] = 0 if c0 > 16 else carry[2] + 1
    bw.flush()
    return bytes(bw.out)


def write_orf(path: str, img: np.ndarray) -> None:
    """Write a synthetic compressed ORF holding ``img`` (H, W) uint16
    top-down: "IIRO" header, raw tags in IFD0, the strip holding 7
    prefix bytes then the bitstream."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    stream = bytes(7) + encode_olympus(img)
    e = "<"
    header = b"II" + struct.pack(e + "H", 0x4F52) + struct.pack(e + "I", 8)
    ifd0_size = 2 + 8 * 12 + 4
    strip_off = 8 + ifd0_size
    ifd0 = _ifd([
        (0x0100, 3, 1, struct.pack(e + "HH", w, 0)),
        (0x0101, 3, 1, struct.pack(e + "HH", h, 0)),
        (0x0102, 3, 1, struct.pack(e + "HH", 12, 0)),
        (0x0103, 3, 1, struct.pack(e + "HH", 65535, 0)),
        (0x0106, 3, 1, struct.pack(e + "HH", 32803, 0)),
        (0x0111, 4, 1, struct.pack(e + "I", strip_off)),
        (0x0116, 3, 1, struct.pack(e + "HH", h, 0)),
        (0x0117, 4, 1, struct.pack(e + "I", len(stream))),
    ], 0, e)
    with open(path, "wb") as f:
        f.write(header)
        f.write(ifd0)
        f.write(stream)


__all__ = ["write_orf", "encode_olympus"]
