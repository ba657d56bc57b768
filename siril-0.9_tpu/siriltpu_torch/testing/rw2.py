"""Synthetic RW2 writer: an encoder for Panasonic's classic 12-bit
compressed scheme plus a minimal RW2 container (TIFF with the 0x0055
magic and the Panasonic IFD0 tags), for round-trip validation of the
native decode path (io/raw.read_rw2_cfa + native/panasonic.cpp)
without any camera file.

The scheme's per-lane delta updates quantize by the active shift code,
so (like the Nikon lossy trees) the encoder tracks the decoder's state
and returns the sequence a conforming decoder reproduces; content
whose same-lane steps stay within the sh=0 window (|delta| <= 127
against an active predictor) encodes exactly.

Port of ``siriltpu.testing.rw2`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from siriltpu_torch.testing.cr2 import _ifd

LOAD_FLAGS = 0x2008


class _PanaWriter:
    """Inverse of the documented pana_bits reader: a countdown bit
    position over 0x4000-byte blocks with 16-byte-group swizzling
    (byte = pos>>3 ^ 0x3ff0) and little-endian in-window packing; on
    disk each block's first ``load_flags`` bytes are stored last."""

    def __init__(self, load_flags: int = LOAD_FLAGS):
        self.load_flags = load_flags
        self.blocks = []
        self.buf = None
        self.vbits = 0

    def put(self, val: int, nbits: int):
        if nbits == 0:
            return
        if self.vbits == 0:
            self.buf = bytearray(0x4000)
            self.blocks.append(self.buf)
            self.vbits = 0x20000
        if self.vbits < nbits:
            raise ValueError("write would straddle a block boundary")
        self.vbits -= nbits
        base = self.vbits & 0x1ffff
        lo = base & 7
        byte = (base >> 3) ^ 0x3ff0
        if byte + 1 > 0x3fff and lo + nbits > 8:
            raise ValueError("window would cross the block guard")
        window = self.buf[byte]
        if byte + 1 <= 0x3fff:
            window |= self.buf[byte + 1] << 8
        window |= (val & ((1 << nbits) - 1)) << lo
        self.buf[byte] = window & 0xFF
        if byte + 1 <= 0x3fff:
            self.buf[byte + 1] = (window >> 8) & 0xFF

    def tobytes(self) -> bytes:
        out = b""
        for b in self.blocks:
            out += bytes(b[self.load_flags:]) + bytes(b[:self.load_flags])
        return out


def _update(pred: int, j: int, sh: int) -> int:
    """The decoder's active-lane delta update for a nonzero j."""
    base = pred - (0x80 << sh)
    if base < 0 or sh == 4:
        base = pred & ~(-1 << sh)
    return base + (j << sh)


_SH_BITS = {0: 0, 1: 1, 2: 2, 4: 3}  # sh value -> 2-bit code


def _lane_best(target: int, i: int, pred_p: int, nonz_p: int, s: int):
    """(err, value, bits, new_nonz) for one lane's pixel at in-group
    index ``i`` under shift ``s``; bits = [(value, width), ...]."""
    if nonz_p:
        keep = (abs(target - pred_p), pred_p, [(0, 8)], nonz_p)
        jj = round((target - _update(pred_p, 1, s) +
                    (1 << s)) / (1 << s))
        jj = min(255, max(1, jj))
        val = _update(pred_p, jj, s)
        move = (abs(target - val), val, [(jj, 8)], nonz_p)
        return min(move, keep, key=lambda c: c[0])
    # inactive lane: either stay low or re-seed absolutely
    if i > 11:
        lowv = min(15, max(0, target))
        opt_a = (abs(target - lowv), lowv, [(0, 8), (lowv, 4)], 0)
    else:
        opt_a = (abs(target), 0, [(0, 8)], 0)
    n = min(255, max(1, target >> 4))
    lowv = min(15, max(0, target - (n << 4)))
    val = n << 4 | lowv
    opt_b = (abs(target - val), val, [(n, 8), (lowv, 4)], n)
    return min(opt_b, opt_a, key=lambda c: c[0])


def encode_panasonic(img: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Encode (H, W) 12-bit values, W a multiple of 14. Returns
    (stream, decoded) where decoded is the exact sequence a conforming
    decoder recovers.

    Width must be a multiple of 14 because every complete 14-pixel
    group consumes exactly 128 bits (8 shift-code bits + 14 eight-bit
    pixel reads + one 4-bit reseed tail per lane), exactly one 16-byte
    swizzle group of the pana_bits layout; a partial group breaks that
    alignment and later bit windows straddle swizzle groups, where
    buf[byte+1] is not the logically-next byte (real Panasonic sensor
    widths are multiples of 14 for the same reason).

    The shift code picked at i%3==2 also binds the next two pixels, so
    it is chosen by simulating all three (sh=4 reaches within ~31 of
    any 12-bit target, which bounds the tracked error even on random
    content)."""
    img = np.asarray(img, np.int64)
    h, w = img.shape
    if w % 14:
        raise ValueError("encode_panasonic width must be a multiple "
                         "of 14 (pad the sensor and crop via borders)")
    wtr = _PanaWriter()
    dec = np.zeros_like(img)
    sh = 0
    for row in range(h):
        for col in range(w):
            i = col % 14
            if i == 0:
                pred = [0, 0]
                nonz = [0, 0]
            p = i & 1
            target = int(img[row, col])

            if i % 3 == 2:
                # re-pick the shift code by lookahead over the pixels
                # it will govern (i .. min(i+2, 13), within the row)
                best_s, best_cost = 0, None
                for s in (0, 1, 2, 4):
                    pp, nz = list(pred), list(nonz)
                    cost = 0
                    for k in range(i, min(14, i + 3)):
                        c2 = col + (k - i)
                        if c2 >= w:
                            break
                        p2 = k & 1
                        e, v, _, nn = _lane_best(int(img[row, c2]), k,
                                                 pp[p2], nz[p2], s)
                        cost += e
                        pp[p2], nz[p2] = v, nn
                    if best_cost is None or cost < best_cost:
                        best_cost, best_s = cost, s
                sh = best_s
                wtr.put(_SH_BITS[sh], 2)

            err, val, bits, new_nonz = _lane_best(target, i, pred[p],
                                                  nonz[p], sh)
            for v, nb in bits:
                wtr.put(v, nb)
            nonz[p] = new_nonz
            pred[p] = val
            dec[row, col] = val
    return wtr.tobytes(), dec


def write_rw2(path: str, img: np.ndarray, *,
              borders: Optional[Tuple[int, int, int, int]] = None
              ) -> np.ndarray:
    """Write a synthetic RW2 holding ``img`` (H, W) 12-bit top-down.
    ``borders`` = (top, left, bottom, right) half-open active area.
    Returns the CFA a conforming decoder must produce (the tracked
    decode, cropped to the borders).

    Widths that are not a multiple of 14 are edge-padded on the right
    to the next multiple (the sensor width real Panasonic bodies use)
    and cropped back through the border tags."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    pad = (-w) % 14
    if pad:
        if borders is None:
            borders = (0, 0, h, w)
        img = np.pad(img, ((0, 0), (0, pad)), mode="edge")
    h, w = img.shape
    stream, dec = encode_panasonic(img)
    e = "<"
    make = b"Panasonic\0"
    entries = [
        (0x0001, 3, 1, struct.pack(e + "HH", 4, 0)),  # raw version
        (0x0002, 3, 1, struct.pack(e + "HH", w, 0)),  # sensor width
        (0x0003, 3, 1, struct.pack(e + "HH", h, 0)),  # sensor height
        (0x000A, 3, 1, struct.pack(e + "HH", 12, 0)),  # bps
    ]
    if borders is not None:
        top, left, bottom, right = borders
        entries += [
            (0x0004, 3, 1, struct.pack(e + "HH", top, 0)),
            (0x0005, 3, 1, struct.pack(e + "HH", left, 0)),
            (0x0006, 3, 1, struct.pack(e + "HH", bottom, 0)),
            (0x0007, 3, 1, struct.pack(e + "HH", right, 0)),
        ]
    n_entries = len(entries) + 2  # + make + raw offset
    ifd0_size = 2 + n_entries * 12 + 4
    make_off = 8 + ifd0_size
    strip_off = make_off + len(make)
    entries += [
        (0x010F, 2, len(make), struct.pack(e + "I", make_off)),
        (0x0118, 4, 1, struct.pack(e + "I", strip_off)),
    ]
    ifd0 = _ifd(entries, 0, e)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack(e + "H", 0x0055) +
                struct.pack(e + "I", 8))
        f.write(ifd0)
        f.write(make)
        f.write(stream)
    expect = dec.astype(np.uint16)
    if borders is not None:
        top, left, bottom, right = borders
        expect = expect[top:bottom, left:right]
    return expect


__all__ = ["write_rw2", "encode_panasonic"]
