"""Synthetic MRW writer: the Minolta \\0MRM container (dcraw
parse_minolta layout) holding a 12-bit MSB-packed or 16-bit unpacked
sample stream, for round-trip validation of the native decode path
(io/raw.read_mrw_cfa) without any camera file. Both storage methods
are exact (no quantization), so round-trips compare against the
planted image.

Port of ``siriltpu.testing.mrw`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct

import numpy as np


def _pack12(img: np.ndarray) -> bytes:
    """12-bit MSB-first packing across byte boundaries."""
    flat = np.asarray(img, np.uint16).ravel()
    bits = ((flat[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def write_mrw(path: str, img: np.ndarray, *, packed: bool = True) -> None:
    """Write a synthetic MRW holding ``img`` (H, W) top-down; 12-bit
    MSB-packed when ``packed`` else 16-bit big-endian unpacked."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    version = b"27730001"  # 8-byte PRD version string
    prd_body = (version + struct.pack(">HHHH", h, w, h, w) +
                bytes([12 if packed else 16, 12,
                       0x59 if packed else 0x52]) + bytes(5))
    prd = b"\x00PRD" + struct.pack(">I", len(prd_body)) + prd_body
    meta = prd
    stream = _pack12(img) if packed else img.astype(">u2").tobytes()
    with open(path, "wb") as f:
        f.write(b"\x00MRM" + struct.pack(">I", len(meta)))
        f.write(meta)
        f.write(stream)


__all__ = ["write_mrw"]
