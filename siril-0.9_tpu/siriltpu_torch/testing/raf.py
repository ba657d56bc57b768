"""Synthetic RAF writer: the Fuji RAF container (dcraw parse_fuji +
identify layout) holding a plain 16-bit big-endian Bayer sample
stream, for round-trip validation of io/raw.read_raf_cfa without any
camera file. The conventional-Bayer stream is exact; ``super_ccd`` /
``xtrans`` flags build files the reader must REFUSE (matching the
reference's "Not really supported, specially XTRANS" stance,
conversion.c:57).

Port of ``siriltpu.testing.raf`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct

import numpy as np


def write_raf(path: str, img: np.ndarray, *, super_ccd: bool = False,
              xtrans: bool = False) -> None:
    """Write a synthetic RAF holding ``img`` (H, W) top-down 16-bit."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    header = bytearray(160)
    header[0:16] = b"FUJIFILMCCD-RAW "
    recs = []
    recs.append((0x100, struct.pack(">HH", h, w)))
    layout_b0 = 0
    layout_b1 = 0x00 if super_ccd else 0x08  # bit 3 clear = Super CCD
    recs.append((0x130, bytes([layout_b0, layout_b1])))
    if xtrans:
        recs.append((0x131, bytes(36)))
    cfa_hdr = struct.pack(">I", len(recs))
    for tag, body in recs:
        cfa_hdr += struct.pack(">HH", tag, len(body)) + body
    cfa_hdr_off = len(header)
    data_off = cfa_hdr_off + len(cfa_hdr)
    struct.pack_into(">I", header, 92, cfa_hdr_off)
    struct.pack_into(">I", header, 100, data_off)
    with open(path, "wb") as f:
        f.write(header)
        f.write(cfa_hdr)
        f.write(img.astype(">u2").tobytes())


__all__ = ["write_raf"]
