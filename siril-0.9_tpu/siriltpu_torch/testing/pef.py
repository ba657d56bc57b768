"""Synthetic PEF writer: a Huffman/differential encoder for Pentax's
compression-65535 bitstream plus a minimal PEF TIFF container (EXIF →
Pentax MakerNote carrying the tag-0x220 code table), for round-trip
validation of the native decode path (io/raw.read_pef_cfa +
native/pentax.cpp) without any camera file.

Unlike Nikon's fixed trees, the PEF table travels in the file as
(12-bit start code, length) pairs indexed by residual category, so the
encoder both *chooses* a canonical table and emits it. Every category
0..dep-1 is present, so encoding is exact — round-trips compare
against the planted image directly.

Port of ``siriltpu.testing.pef`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from siriltpu_torch.testing.cr2 import _ifd
from siriltpu_torch.testing.nef import _BitWriter


def make_code_table(lens: Sequence[int]) -> List[int]:
    """Canonical Huffman codes for per-category lengths (category c
    gets lens[c]); returns the code values. Shorter codes first, ties
    by category, exactly the assignment any canonical code construction makes."""
    order = sorted(range(len(lens)), key=lambda c: (lens[c], c))
    codes = [0] * len(lens)
    code = 0
    prev = 0
    for c in order:
        code <<= lens[c] - prev
        prev = lens[c]
        codes[c] = code
        code += 1
    return codes


# Kraft-complete-enough defaults: small categories get short codes
_DEFAULT_LENS = {
    13: [2, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 11],   # 12-bit
    15: [2, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 12, 12],  # 14-bit
}


def encode_pentax(img: np.ndarray, lens: Sequence[int]) -> bytes:
    """Encode (H, W) values with the category table ``lens``. The
    predictor scheme mirrors the decoder: zero-seeded per-row-parity
    vertical predictors for the first two columns, column-pair
    horizontal predictors elsewhere."""
    img = np.asarray(img, np.int64)
    h, w = img.shape
    codes = make_code_table(lens)
    vp = [[0, 0], [0, 0]]
    hp = [0, 0]
    bw = _BitWriter()
    for row in range(h):
        for col in range(w):
            pred = vp[row & 1][col] if col < 2 else hp[col & 1]
            val = int(img[row, col])
            diff = val - pred
            cat = abs(diff).bit_length()
            if cat >= len(lens):
                raise ValueError(f"residual {diff} needs category "
                                 f"{cat} > table depth {len(lens) - 1}")
            bw.put(codes[cat], lens[cat])
            if cat:
                bw.put(diff if diff >= 0 else diff + (1 << cat) - 1, cat)
            if col < 2:
                vp[row & 1][col] = val
            hp[col & 1] = val
    bw.flush()
    return bytes(bw.out)


def _pef_meta(lens: Sequence[int], e: str) -> bytes:
    """The tag-0x220 blob: (dep-12) short, 12 pad bytes, dep 12-bit
    start codes, dep lengths."""
    dep = len(lens)
    codes = make_code_table(lens)
    meta = struct.pack(e + "H", (dep - 12) & 15) + bytes(12)
    for c in range(dep):
        meta += struct.pack(e + "H", codes[c] << (12 - lens[c]))
    meta += bytes(lens)
    return meta


def write_pef(path: str, img: np.ndarray, *, bps: int = 12,
              lens: Optional[Sequence[int]] = None,
              makernote: str = "PENTAX") -> None:
    """Write a synthetic compressed PEF holding ``img`` (H, W) uint16
    top-down. ``makernote`` selects the "PENTAX " (modern, relative
    offsets) or "AOC" (older, absolute offsets) flavor."""
    img = np.asarray(img, np.uint16)
    h, w = img.shape
    if lens is None:
        lens = _DEFAULT_LENS[13 if bps == 12 else 15]
    stream = encode_pentax(img, lens)
    e = "<"
    meta = _pef_meta(lens, e)

    make = b"PENTAX Corporation\0"
    header = b"II*\0" + struct.pack(e + "I", 8)
    ifd0_size = 2 + 3 * 12 + 4
    ifd0_off = 8
    make_off = ifd0_off + ifd0_size
    exif_size = 2 + 12 + 4
    exif_off = make_off + len(make)
    mn_off = exif_off + exif_size

    if makernote == "PENTAX":
        # "PENTAX \0" + order + IFD at +10, offsets relative to start
        inner_meta_off = 10 + 2 + 12 + 4
        mn = (b"PENTAX \x00II" +
              _ifd([(0x0220, 7, len(meta),
                     struct.pack(e + "I", inner_meta_off))], 0, e) + meta)
    elif makernote == "AOC":
        # "AOC\0" + 2 bytes + IFD at +6, ABSOLUTE file offsets
        meta_abs = mn_off + 6 + 2 + 12 + 4
        mn = (b"AOC\x00\0\0" +
              _ifd([(0x0220, 7, len(meta),
                     struct.pack(e + "I", meta_abs))], 0, e) + meta)
    else:
        raise ValueError(f"unknown makernote flavor {makernote!r}")

    raw_ifd_off = mn_off + len(mn)
    raw_ifd_size = 2 + 8 * 12 + 4
    strip_off = raw_ifd_off + raw_ifd_size

    ifd0 = _ifd([
        (0x010F, 2, len(make), struct.pack(e + "I", make_off)),
        (0x014A, 4, 1, struct.pack(e + "I", raw_ifd_off)),
        (0x8769, 4, 1, struct.pack(e + "I", exif_off)),
    ], 0, e)
    exif = _ifd([
        (0x927C, 7, len(mn), struct.pack(e + "I", mn_off)),
    ], 0, e)
    raw_ifd = _ifd([
        (0x0100, 3, 1, struct.pack(e + "HH", w, 0)),
        (0x0101, 3, 1, struct.pack(e + "HH", h, 0)),
        (0x0102, 3, 1, struct.pack(e + "HH", bps, 0)),
        (0x0103, 3, 1, struct.pack(e + "HH", 65535, 0)),
        (0x0106, 3, 1, struct.pack(e + "HH", 32803, 0)),
        (0x0111, 4, 1, struct.pack(e + "I", strip_off)),
        (0x0116, 3, 1, struct.pack(e + "HH", h, 0)),
        (0x0117, 4, 1, struct.pack(e + "I", len(stream))),
    ], 0, e)

    with open(path, "wb") as f:
        f.write(header)
        f.write(ifd0)
        f.write(make)
        f.write(exif)
        f.write(mn)
        f.write(raw_ifd)
        f.write(stream)


__all__ = ["write_pef", "encode_pentax", "make_code_table"]
