"""Synthetic CR2 writer: a lossless-JPEG (SOF3) encoder + minimal CR2
TIFF container, for round-trip validation of the native CR2 decode path
(io/raw.read_cr2_cfa + native/lj92.cpp) without any real camera file.

The encoder emits exactly what ITU T.81's lossless process (and
lj92.cpp) defines: predictor Ss=1 (Ra; Rb for the first column, the
1<<(P-1) default for the very first sample), SSSS Huffman categories
with the magnitude-extension convention, 0xFF byte stuffing. The
container mirrors the documented dcraw CR2 layout: IFD0 with Make +
EXIF IFD (Canon MakerNote SensorInfo for the active-area crop), a last
chained IFD with compression=6 holding the strip, and tag 0xc640
giving the vertical slice widths.

Port of ``siriltpu.testing.cr2`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------ SOF3 encoding

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

    def flush(self):
        if self.nbits:
            self.acc <<= (8 - self.nbits)
            self.acc |= (1 << (8 - self.nbits)) - 1  # pad with 1s
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0


# canonical Huffman: all 17 SSSS symbols (0..16) at 5 bits
_HUF_COUNTS = bytes([0, 0, 0, 0, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])
_HUF_VALUES = bytes(range(17))
_HUF_CODE = {s: (s, 5) for s in range(17)}  # canonical: code == index


def _ssss(diff: int) -> int:
    return int(abs(diff)).bit_length()


def encode_sof3(samples: np.ndarray, ncomp: int, precision: int = 14
                ) -> bytes:
    """Encode (H, W*ncomp) uint16 rows as one SOF3 stream (predictor 1,
    1x1 sampling, the layout lj92.cpp and DNG/CR2 use)."""
    h, row = samples.shape
    assert row % ncomp == 0
    w = row // ncomp
    flat = samples.astype(np.int64).ravel()
    bw = _BitWriter()
    default = 1 << (precision - 1)
    nf = ncomp
    for idx in range(flat.size):
        x = (idx // nf) % w
        y = idx // (w * nf)
        if idx < nf and y == 0 and x == 0:
            px = default
        elif x == 0:
            px = int(flat[idx - w * nf])   # Rb (first col: prev row)
        elif y == 0:
            px = int(flat[idx - nf])       # Ra on the first row
        else:
            px = int(flat[idx - nf])       # predictor 1: Ra
        diff = (int(flat[idx]) - px) & 0xFFFF
        if diff >= 32768:
            diff -= 65536
        if diff == -32768:
            s = 16
            code, nb = _HUF_CODE[s]
            bw.put(code, nb)  # SSSS=16: no extension bits, diff=32768
            continue
        s = _ssss(diff)
        code, nb = _HUF_CODE[s]
        bw.put(code, nb)
        if s:
            v = diff if diff >= 0 else diff + (1 << s) - 1
            bw.put(v, s)
    bw.flush()

    seg = bytearray()
    seg += b"\xFF\xD8"  # SOI
    # DHT
    dht = bytes([0x00]) + _HUF_COUNTS + _HUF_VALUES
    seg += b"\xFF\xC4" + struct.pack(">H", 2 + len(dht)) + dht
    # SOF3
    sof = bytearray(struct.pack(">BHHB", precision, h, w, ncomp))
    for c in range(ncomp):
        sof += bytes([c, 0x11, 0])
    seg += b"\xFF\xC3" + struct.pack(">H", 2 + len(sof)) + bytes(sof)
    # SOS: predictor Ss=1, Se=0, Ah/Al=0
    sos = bytearray([ncomp])
    for c in range(ncomp):
        sos += bytes([c, 0x00])
    sos += bytes([1, 0, 0])
    seg += b"\xFF\xDA" + struct.pack(">H", 2 + len(sos)) + bytes(sos)
    seg += bw.out
    seg += b"\xFF\xD9"  # EOI
    return bytes(seg)


# ---------------------------------------------------- CR2 container

def _ifd(entries, next_off: int, e: str = "<") -> bytes:
    out = struct.pack(e + "H", len(entries))
    for tag, typ, count, value in sorted(entries):
        out += struct.pack(e + "HHI", tag, typ, count) + value
    out += struct.pack(e + "I", next_off)
    return out


def write_cr2(path: str, cfa: np.ndarray, *, ncomp: int = 2,
              slices: Optional[Tuple[int, int, int]] = None,
              borders: Optional[Tuple[int, int, int, int]] = None,
              precision: int = 14) -> None:
    """Write a synthetic CR2 holding ``cfa`` (H, W) uint16 top-down.

    ``slices``: (count, width, last_width) in raster columns (must sum
    to W); default = one slice. ``borders``: (left, top, right, bottom)
    inclusive ACTIVE AREA within a larger raster — when given, ``cfa``
    is the full raster and readers should crop to the borders.
    """
    cfa = np.asarray(cfa, np.uint16)
    h, w = cfa.shape
    assert w % ncomp == 0
    if slices is None:
        slices = (0, w, w)
    n_sl, w_sl, w_last = slices
    if n_sl:
        assert n_sl * w_sl + w_last == w
        parts = []
        col = 0
        for k in range(n_sl + 1):
            wk = w_sl if k < n_sl else w_last
            parts.append(cfa[:, col: col + wk].ravel())
            col += wk
        stream = np.concatenate(parts).reshape(h, w)
    else:
        stream = cfa
    blob = encode_sof3(stream, ncomp, precision)

    e = "<"
    # layout: header(8) + CR2 magic(8) | IFD0 | EXIF IFD | MakerNote IFD |
    #         sensorinfo data | raw IFD | blob
    header = b"II*\0" + struct.pack(e + "I", 16) + b"CR\x02\x00\0\0\0\0"
    pos = len(header)

    # sizes: IFD0 has 2 entries (Make ptr, ExifIFD); strings out-of-line
    make = b"Canon\0"
    ifd0_size = 2 + 2 * 12 + 4
    exif_size = 2 + 1 * 12 + 4
    mk_size = 2 + 1 * 12 + 4
    si = None
    if borders is not None:
        left, top, right, bottom = borders
        si = [9, w, h, 0, 0, left, top, right, bottom]
    si_size = 2 * len(si) if si else 0

    ifd0_off = pos
    make_off = ifd0_off + ifd0_size
    exif_off = make_off + len(make)
    mk_off = exif_off + exif_size
    si_off = mk_off + mk_size
    raw_ifd_off = si_off + si_size
    raw_ifd_size = 2 + 3 * 12 + 4
    blob_off = raw_ifd_off + raw_ifd_size

    ifd0 = _ifd([
        (0x010F, 2, len(make), struct.pack(e + "I", make_off)),
        (0x8769, 4, 1, struct.pack(e + "I", exif_off)),
    ], raw_ifd_off, e)

    exif = _ifd([
        (0x927C, 4, 1, struct.pack(e + "I", mk_off)),  # MakerNote ptr
    ], 0, e)
    if si:
        mk = _ifd([(0x00E0, 3, len(si), struct.pack(e + "I", si_off))], 0, e)
        si_bytes = b"".join(struct.pack(e + "H", v) for v in si)
    else:
        mk = _ifd([(0x00E0, 3, 0, b"\0\0\0\0")], 0, e)
        si_bytes = b""

    raw_entries = [
        (0x0103, 3, 1, struct.pack(e + "HH", 6, 0)),          # compression=6
        (0x0111, 4, 1, struct.pack(e + "I", blob_off)),       # StripOffsets
        (0x0117, 4, 1, struct.pack(e + "I", len(blob))),      # ByteCounts
    ]
    if n_sl:
        raw_entries.append(
            (0xC640, 3, 3, b""))  # placeholder, replaced below
        raw_ifd_size = 2 + 4 * 12 + 4
        blob_off = raw_ifd_off + raw_ifd_size
        sl_off = blob_off + len(blob)
        raw_entries = [
            (0x0103, 3, 1, struct.pack(e + "HH", 6, 0)),
            (0x0111, 4, 1, struct.pack(e + "I", blob_off)),
            (0x0117, 4, 1, struct.pack(e + "I", len(blob))),
            (0xC640, 3, 3, struct.pack(e + "I", sl_off)),
        ]
        trailer = struct.pack(e + "HHH", n_sl, w_sl, w_last)
    else:
        trailer = b""
    raw_ifd = _ifd(raw_entries, 0, e)

    with open(path, "wb") as f:
        f.write(header)
        f.write(ifd0)
        f.write(make)
        f.write(exif)
        f.write(mk)
        f.write(si_bytes)
        f.write(raw_ifd)
        f.write(blob)
        f.write(trailer)


__all__ = ["write_cr2", "encode_sof3"]
