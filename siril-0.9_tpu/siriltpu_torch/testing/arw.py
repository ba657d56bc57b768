"""Synthetic Sony ARW2 ("cRAW") writer + scalar reference decoder.

Validates the vectorized native decoder (io/raw.decode_arw2) two ways:

- ``decode_arw2_scalar`` is a direct per-pixel transliteration of the
  documented dcraw ``sony_arw2_load_raw`` bitstream semantics (16-byte
  block = 11-bit max/min + 4-bit indices + fourteen 7-bit shifted
  deltas, two blocks interleaving a 32-column span); feeding BOTH
  decoders the same (even random) strips is a differential test of the
  vectorization.
- ``encode_arw2`` + ``write_arw`` produce standalone .arw files for
  round-trip tests through the public ``read_raw_cfa`` path; blocks
  whose value range fits 7 bits round-trip losslessly.

Port of ``siriltpu.testing.arw`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from siriltpu_torch.testing.cr2 import _ifd


def decode_arw2_scalar(strip: bytes, h: int, w: int,
                       curve: np.ndarray) -> np.ndarray:
    """Per-pixel reference decode (rows padded with two zero bytes,
    matching the vectorized decoder's over-read convention)."""
    data = np.frombuffer(strip, np.uint8, h * w).astype(np.int64)
    out = np.zeros((h, w), np.uint16)
    for row in range(h):
        buf = np.concatenate([data[row * w: (row + 1) * w], [0, 0]])
        col = 0
        dp = 0
        while col < w - 30:
            val = int(buf[dp] | buf[dp + 1] << 8 | buf[dp + 2] << 16 |
                      buf[dp + 3] << 24)
            mx = val & 0x7FF
            mn = val >> 11 & 0x7FF
            imax = val >> 22 & 0xF
            imin = val >> 26 & 0xF
            sh = 0
            while sh < 4 and 0x80 << sh <= mx - mn:
                sh += 1
            bit = 30
            pix = [0] * 16
            for i in range(16):
                if i == imax:
                    pix[i] = mx
                elif i == imin:
                    pix[i] = mn
                else:
                    b, s = bit >> 3, bit & 7
                    v = (int(buf[dp + b] | buf[dp + b + 1] << 8)
                         >> s) & 0x7F
                    pix[i] = min((v << sh) + mn, 0x7FF)
                    bit += 7
            for i in range(16):
                out[row, col] = curve[pix[i] << 1] >> 2
                col += 2
            col -= 1 if col & 1 else 31
            dp += 16
    return out


def encode_arw2(pix11: np.ndarray) -> bytes:
    """Encode an (H, W) array of 11-bit sensor values as ARW2 strip
    bytes (one byte per pixel per row). W % 32 == 0 encodes full pairs;
    W % 32 == 31 additionally encodes the reference's lone trailing
    EVEN block (dcraw bound ``col < raw_width-30``). Blocks with range
    > 127 quantize exactly the way the decoder's ``sh`` rule dictates
    (lossy, like the camera)."""
    pix11 = np.asarray(pix11, np.int64)
    h, w = pix11.shape
    assert w % 32 in (0, 31), "ARW2 width must be 32k or 32k+31"

    def encode_block(blockpix):
        blk = bytearray(16)
        mx, mn = int(blockpix.max()), int(blockpix.min())
        imax, imin = int(blockpix.argmax()), int(blockpix.argmin())
        if imax == imin:           # constant block: avoid the
            imin = (imax + 1) % 16  # 15-field overflow case
        sh = 0
        while sh < 4 and 0x80 << sh <= mx - mn:
            sh += 1
        hdr = mx | mn << 11 | imax << 22 | imin << 26
        struct.pack_into("<I", blk, 0, hdr)
        bit = 30
        for i in range(16):
            if i in (imax, imin):
                continue
            v = (int(blockpix[i]) - mn) >> sh
            v = max(0, min(v, 0x7F))
            for j in range(7):
                if v >> j & 1:
                    blk[(bit + j) >> 3] |= 1 << ((bit + j) & 7)
            bit += 7
        return bytes(blk)

    out = bytearray()
    for row in range(h):
        nrow = 0
        for p in range(w // 32):
            for parity in (0, 1):
                out += encode_block(
                    pix11[row, 32 * p + parity: 32 * p + 32: 2])
                nrow += 16
        if w % 32 == 31:
            p = w // 32
            out += encode_block(pix11[row, 32 * p: 32 * p + 31: 2])
            nrow += 16
        out += b"\x00" * (w - nrow)  # rows are raw_width bytes
    return bytes(out)


def write_arw(path: str, strip: bytes, h: int, w: int, *,
              curve_breaks: Optional[Sequence[int]] = None) -> None:
    """Minimal .arw container: one IFD with the ARW2 raw strip
    (compression 32767, CFA photometric) and, when given, the SR2
    tone-curve tag 0x7010 (stored shifted left 2, as consumers apply
    ``>>2 & 0xfff``)."""
    entries = []
    header = 8
    ntags = 7 + (1 if curve_breaks is not None else 0)
    ifd_size = 2 + 12 * ntags + 4
    extra_off = header + ifd_size
    extra = bytearray()

    def _short(tag, v):
        entries.append((tag, 3, 1, struct.pack("<HH", v, 0)))

    def _long(tag, v):
        entries.append((tag, 4, 1, struct.pack("<I", v)))

    _long(256, w)
    _long(257, h)
    _short(258, 12)
    _short(259, 32767)
    _short(262, 32803)
    if curve_breaks is not None:
        vals = [min(0xFFF, int(b)) << 2 for b in curve_breaks][:4]
        entries.append((0x7010, 3, 4,
                        struct.pack("<I", extra_off + len(extra))))
        extra += struct.pack("<4H", *vals)
    strip_off = extra_off + len(extra)
    _long(273, strip_off)
    _long(279, len(strip))
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", header))
        f.write(_ifd(entries, 0))
        f.write(bytes(extra))
        f.write(strip)


__all__ = ["decode_arw2_scalar", "encode_arw2", "write_arw"]
