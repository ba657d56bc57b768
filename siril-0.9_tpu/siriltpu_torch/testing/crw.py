"""Synthetic CRW (CIFF) writer for round-trip validation of the native
Canon CRW decode path (io/raw.read_crw_cfa + native/canon_crw.cpp)
without any real camera file.

The encoder emits the documented CRW layout: 26-byte "HEAPCCDR" header,
optional 2-bit low-order plane at offset 26, the 64-sample-block
Huffman-compressed 10-bit plane at 540 + lowbits·H·W/4 (column-parity
predictors re-seeded to 512 each sensor row, block-DC carry, JPEG
0xff 0x00 stuffing), and a CIFF heap directory at the end carrying
SensorInfo (0x1031) and the decoder-table record (0x1835).

Canonical Huffman codes are obtained from the DECODER's own tables via
``crw_leaf_code`` (native/canon_crw.cpp) — the round trip proves the
machinery (runs, sign extension, predictors, stuffing, container walk),
not an independent transcription of the table bytes; see the decoder's
TABLE PROVENANCE note.

Port of ``siriltpu.testing.crw`` (NumPy): copied; the leaf codes come from
the port's build of the native decoder (``io.raw._load_crw``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)  # byte stuffing
                self.acc = 0
                self.nbits = 0

    def flush(self) -> bytes:
        if self.nbits:
            self.acc <<= (8 - self.nbits)
            self.acc |= (1 << (8 - self.nbits)) - 1  # pad with 1s
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def _leaf_codes():
    """(first, second) dicts: leaf byte -> (code, length), from the
    decoder's own tables."""
    from siriltpu_torch.io.raw import _load_crw
    lib = _load_crw()
    if lib is None:
        raise RuntimeError("native CRW decoder unavailable")
    tables = []
    for which in (0, 1):
        d = {}
        for leaf in range(256):
            packed = lib.crw_leaf_code(which, leaf)
            if packed:
                d[leaf] = (packed & 0xffff, packed >> 16)
        tables.append(d)
    return tables[0], tables[1]


def _encode_plane(plane: np.ndarray) -> bytes:
    """Compress a (H, W) array of 10-bit samples into the CRW block
    stream."""
    h, w = plane.shape
    assert (h * w) % 64 == 0 and w % 2 == 0
    first, second = _leaf_codes()
    flat = plane.astype(np.int32).ravel()

    # per-position diffs under the decoder's predictor scheme
    diffs = np.empty(h * w, np.int32)
    base = [0, 0]
    for p in range(h * w):
        i = p % 64
        if p % w == 0:
            base[0] = base[1] = 512
        diffs[p] = flat[p] - base[i & 1]
        base[i & 1] = flat[p]

    bw = _BitWriter()
    carry = 0
    for b0 in range(0, h * w, 64):
        block = diffs[b0: b0 + 64].copy()
        # the decoder adds the running carry to diffbuf[0]
        want0 = int(block[0])
        block[0] = want0 - carry
        carry = want0

        def emit(leaf, table):
            code, ln = table[leaf]
            bw.put(code, ln)

        # DC sample
        d = int(block[0])
        ln = int(abs(d)).bit_length()
        emit(ln, first)
        if ln:
            bw.put(d if d >= 0 else d + (1 << ln) - 1, ln)
        # AC samples with zero-run coding
        i = 1
        while i < 64:
            if not block[i:].any():
                emit(0x00, second)  # end of block
                break
            run = 0
            while block[i] == 0:
                run += 1
                i += 1
            while run >= 16:
                emit(0xf0, second)  # skip 16 zeros
                run -= 16
            d = int(block[i])
            ln = int(abs(d)).bit_length()
            leaf = (run << 4) | ln
            if leaf not in second:
                raise ValueError(
                    f"no Huffman leaf for run={run} len={ln}; constrain "
                    f"the synthetic data")
            emit(leaf, second)
            bw.put(d if d >= 0 else d + (1 << ln) - 1, ln)
            i += 1
    return bw.flush()


def write_crw(path: str, plane: np.ndarray, *, lowbits: bool = True,
              crop: Optional[Tuple[int, int, int, int]] = None) -> None:
    """Write a CRW file holding ``plane`` ((H, W) uint16).

    With ``lowbits`` the full 12-bit values are split into a 10-bit
    compressed plane plus the 2-bit low-order plane at offset 26;
    otherwise the values must be 10-bit. ``crop`` = (left, top, right,
    bottom) inclusive SensorInfo borders.
    """
    plane = np.asarray(plane)
    h, w = plane.shape
    assert (h * w) % 64 == 0 and w % 2 == 0 and h % 8 == 0
    if lowbits:
        assert int(plane.max()) < 4096, "lowbits files carry 12-bit values"
        hi = (plane >> 2).astype(np.uint16)
        lo = (plane & 3).astype(np.uint8)
        lb = np.zeros(h * w // 4, np.uint8)
        flat = lo.ravel()
        for r in range(4):
            lb |= (flat[r::4] << (2 * r)).astype(np.uint8)
        low_plane = lb.tobytes()
    else:
        assert int(plane.max()) < 1024, "no-lowbits files carry 10-bit values"
        hi = plane.astype(np.uint16)
        low_plane = b""

    stream = _encode_plane(hi)

    # canon_has_lowbits scans [540, 0x4000): for lowbits files any
    # 0xff 0x00 pair (or no 0xff) must appear there — the low plane is
    # arbitrary data, so plant a 0xff 0x00 right after it if it is
    # shorter than the window; for no-lowbits files the STREAM occupies
    # the window and its only 0xff bytes are stuffed (0xff 0x00), which
    # would flip detection — so verify none occur in the window.
    data_off = 540 + len(low_plane)
    out = bytearray()
    out += b"II" + struct.pack("<I", 26) + b"HEAPCCDR"
    out += struct.pack("<I", 0x00010002)  # version
    out += b"\x00" * (26 - len(out))
    out += low_plane
    out += b"\x00" * (data_off - len(out))
    out += stream

    if lowbits:
        out += b"\xff\x00"  # guarantees detection inside the window
    else:
        win = bytes(out[540: 0x4000])
        for i in range(len(win) - 1):
            if win[i] == 0xff and win[i + 1] == 0x00:
                raise ValueError(
                    "stuffed 0xff in the detection window would flip "
                    "canon_has_lowbits; reroll the synthetic data")
        if 0xff not in win:
            # no 0xff at all defaults to lowbits=1: plant 0xff 0x01
            out += b"\xff\x01"

    # CIFF heap directory (heap starts at byte 26)
    heap = 26
    sensor = np.zeros(17, "<u2")
    sensor[1], sensor[2] = w, h
    if crop is not None:
        sensor[5], sensor[6], sensor[7], sensor[8] = crop
    si_off = len(out) - heap
    out += sensor.tobytes()
    dt_off = len(out) - heap
    out += struct.pack("<III", 0, 0, 0)  # decoder table 0 + padding
    dir_off = len(out) - heap
    out += struct.pack("<H", 2)
    out += struct.pack("<HII", 0x1031, 34, si_off)
    out += struct.pack("<HII", 0x1835, 12, dt_off)
    out += struct.pack("<I", dir_off)
    from siriltpu_torch.io.raw import _crw_has_lowbits
    if _crw_has_lowbits(bytes(out)) != lowbits:
        raise ValueError("heap bytes flipped canon_has_lowbits; reroll "
                         "the synthetic geometry")
    with open(path, "wb") as f:
        f.write(bytes(out))


__all__ = ["write_crw"]
