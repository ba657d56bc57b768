"""Synthetic NEF writer: a Huffman/differential encoder for Nikon's
compression-34713 bitstream plus a minimal NEF TIFF container (EXIF →
Nikon MakerNote with an embedded TIFF holding the tag-0x96
linearization blob), for round-trip validation of the native decode
path (io/raw.read_nef_cfa + native/nikon.cpp) without any camera file.

The encoder mirrors the decoder's state machine exactly (vertical
predictors for the first two columns, per-column-pair horizontal
predictors, tree switch at the split row) and — because the
post-split trees quantize the high residual categories — returns the
sequence a conforming decoder reproduces alongside the bitstream, so
tests compare against the encoder's own tracked decode, which equals
the input wherever the tree is exact (always, for the lossless trees).

Port of ``siriltpu.testing.nef`` (NumPy): copied, with the imports
pointed at the port.
"""

from __future__ import annotations

import struct
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

import numpy as np

from siriltpu_torch.testing.cr2 import _ifd

# Same format-defined tables as native/nikon.cpp: 16 code-length
# counts then leaf values (low nibble = residual length, high nibble =
# left-shift for the quantized post-split trees).
NIKON_TREES = [
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12],
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     0x39, 0x5a, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0, 11, 12, 12],
    [0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12],
    [0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0,
     5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14],
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0,
     8, 0x5c, 0x4b, 0x3a, 0x29, 7, 6, 5, 4, 3, 2, 1, 0, 13, 14],
    [0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0,
     7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14]]


class _BitWriter:
    """MSB-first bit accumulator, no byte stuffing (the NEF stream has
    none, unlike JPEG)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.n = 0

    def flush(self):
        if self.n:
            self.out.append(self.acc << (8 - self.n))
            self.acc = 0
            self.n = 0


def _canonical_codes(spec: List[int]) -> Dict[int, Tuple[int, int]]:
    """leaf value -> (code, length), canonical assignment in table
    order (duplicated leaves keep their first, shortest code)."""
    # the on-format tables are zero-padded to 32 bytes and the counts
    # may address leaves inside that padding (tree 0 does: its 14th
    # leaf is a duplicate value-0 from the pad)
    counts, vals = spec[:16], spec[16:] + [0] * 16
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            v = vals[k]
            k += 1
            codes.setdefault(v, (code, ln))
            code += 1
        code <<= 1
    return codes


def _leaf_diffs(leaf: int) -> Dict[int, Tuple[int, int]]:
    """All residuals a leaf can encode: diff -> (extra bits, count)."""
    nbits, shl = leaf & 15, leaf >> 4
    if nbits == 0:
        return {0: (0, 0)}
    out: Dict[int, Tuple[int, int]] = {}
    for b in range(1 << (nbits - shl)):
        raw = ((b << 1) + 1) << shl >> 1
        if raw & (1 << (nbits - 1)):
            d = raw
        else:
            d = raw - ((1 << nbits) - (1 if shl == 0 else 0))
        out[d] = (b, nbits - shl)
    return out


class _TreeEncoder:
    def __init__(self, spec: List[int]):
        self.codes = _canonical_codes(spec)
        # diff -> (leaf, extra, n_extra); prefer the shortest total code
        best: Dict[int, Tuple[int, int, int, int]] = {}
        for leaf in self.codes:
            _, ln = self.codes[leaf]
            for d, (b, nb) in _leaf_diffs(leaf).items():
                cost = ln + nb
                if d not in best or cost < best[d][0]:
                    best[d] = (cost, leaf, b, nb)
        self.by_diff = {d: v[1:] for d, v in best.items()}
        self.sorted_diffs = sorted(self.by_diff)

    def nearest(self, want: int) -> int:
        """Closest encodable residual to ``want``."""
        ds = self.sorted_diffs
        i = bisect_left(ds, want)
        cands = [ds[j] for j in (i - 1, i) if 0 <= j < len(ds)]
        return min(cands, key=lambda d: (abs(d - want), d))

    def emit(self, bw: _BitWriter, d: int):
        leaf, b, nb = self.by_diff[d]
        code, ln = self.codes[leaf]
        bw.put(code, ln)
        if nb:
            bw.put(b, nb)


def encode_nikon(img: np.ndarray, tree: int, vpred: np.ndarray,
                 split: int = 0) -> Tuple[bytes, np.ndarray]:
    """Encode (H, W) predictor-domain values with ``NIKON_TREES[tree]``
    (switching to tree+1 at row ``split`` when nonzero). Returns
    (bitstream, decoded) where decoded is the exact per-pixel value a
    conforming decoder recovers (== img when residuals are encodable,
    which holds everywhere except the quantized post-split categories).
    """
    img = np.asarray(img, np.int64)
    h, w = img.shape
    enc = _TreeEncoder(NIKON_TREES[tree])
    vp = [[int(vpred[0]), int(vpred[1])], [int(vpred[2]), int(vpred[3])]]
    hp = [0, 0]
    dec = np.zeros_like(img)
    bw = _BitWriter()
    for row in range(h):
        if split and row == split:
            enc = _TreeEncoder(NIKON_TREES[tree + 1])
        for col in range(w):
            pred = vp[row & 1][col] if col < 2 else hp[col & 1]
            d = enc.nearest(int(img[row, col]) - pred)
            enc.emit(bw, d)
            val = pred + d
            if col < 2:
                vp[row & 1][col] = val
            hp[col & 1] = val
            dec[row, col] = val
    bw.flush()
    return bytes(bw.out), dec


# ------------------------------------------------------- container

def _nef_meta(ver: Tuple[int, int], vpred: np.ndarray, bps: int,
              curve_pts: Optional[np.ndarray], split: int,
              direct_curve: Optional[np.ndarray]) -> bytes:
    """Build the tag-0x96 blob in the documented layout (see
    io/raw._nef_meta_decode)."""
    ver0, ver1 = ver
    meta = bytearray([ver0, ver1])
    if ver0 == 0x49 or ver1 == 0x58:
        meta += bytes(2110)  # the D100-family pre-predictor gap
    meta += np.asarray(vpred, "<u2").tobytes()
    if curve_pts is not None:  # lossy v0x44.20: sampled curve + split
        meta += struct.pack("<H", len(curve_pts))
        meta += np.asarray(curve_pts, "<u2").tobytes()
        if len(meta) > 562:
            raise ValueError("curve too long for the split slot")
        meta += bytes(562 - len(meta))
        meta += struct.pack("<H", split)
    elif direct_curve is not None:  # direct table (non-0x44.20 lossy)
        meta += struct.pack("<H", len(direct_curve))
        meta += np.asarray(direct_curve, "<u2").tobytes()
    else:  # no explicit curve: one identity sample (curve[0] = 0)
        meta += struct.pack("<H", 1) + struct.pack("<H", 0)
    return bytes(meta)


def write_nef(path: str, img: np.ndarray, *, bps: int = 12,
              lossless: bool = True,
              curve_pts: Optional[np.ndarray] = None,
              direct_curve: Optional[np.ndarray] = None,
              split: int = 0, d100_skip: bool = False,
              vpred: Optional[np.ndarray] = None) -> np.ndarray:
    """Write a synthetic compressed NEF holding ``img`` (H, W) values in
    the PREDICTOR domain (pre-curve), top-down. Returns the CFA a
    conforming decoder must produce (post-quantization, post-curve,
    post 0..0x3fff clip) for the round-trip assert.

    ``lossless`` selects ver 0x46.30 (identity curve); otherwise ver
    0x44.20 when ``curve_pts`` is given (with ``split``), or a direct
    curve table version 0x43.00 when ``direct_curve`` is given.
    ``d100_skip`` uses ver0=0x49 to exercise the 2110-byte gap.
    """
    img = np.asarray(img)
    h, w = img.shape
    if vpred is None:
        vpred = np.full(4, 1 << (bps - 1), np.uint16)
    tree = 2 if lossless else 0
    if bps == 14:
        tree += 3
    if lossless:
        ver = (0x46, 0x30)
    elif curve_pts is not None:
        ver = (0x44, 0x20)
    elif d100_skip:
        ver = (0x49, 0x00)
    else:
        ver = (0x43, 0x00)
    stream, dec = encode_nikon(img, tree, vpred, split=split)
    meta = _nef_meta(ver, vpred, bps, curve_pts, split, direct_curve)

    # expected decoder output: clip, then the curve
    curve = np.arange(65536, dtype=np.int64)
    maxv = (1 << bps) & 0x7fff
    if curve_pts is not None:
        csize = len(curve_pts)
        step = maxv // (csize - 1)
        cp = curve.copy()
        cp[np.arange(csize) * step] = np.asarray(curve_pts, np.int64)
        i = np.arange(maxv, dtype=np.int64)
        lo, f = i - i % step, i % step
        curve[:maxv] = cp[lo] + ((cp[lo + step] - cp[lo]) * f) // step
    elif direct_curve is not None:
        curve[:len(direct_curve)] = np.asarray(direct_curve, np.int64)
    expect = curve[np.clip(dec, 0, 0x3fff)].astype(np.uint16)

    e = "<"
    make = b"NIKON CORPORATION\0"
    # MakerNote: "Nikon\0" + version + embedded TIFF (own header,
    # offsets relative to it) holding tag 0x96 -> meta blob
    inner_ifd_off = 8
    inner_ifd_size = 2 + 12 + 4
    meta_off = inner_ifd_off + inner_ifd_size
    inner = (b"II*\0" + struct.pack(e + "I", inner_ifd_off) +
             _ifd([(0x0096, 7, len(meta),
                    struct.pack(e + "I", meta_off))], 0, e) + meta)
    mn = b"Nikon\x00\x02\x10\x00\x00" + inner

    header = b"II*\0" + struct.pack(e + "I", 8)
    ifd0_size = 2 + 3 * 12 + 4
    ifd0_off = 8
    make_off = ifd0_off + ifd0_size
    exif_size = 2 + 12 + 4
    exif_off = make_off + len(make)
    mn_off = exif_off + exif_size
    raw_ifd_off = mn_off + len(mn)
    raw_ifd_size = 2 + 8 * 12 + 4
    strip_off = raw_ifd_off + raw_ifd_size

    ifd0 = _ifd([
        (0x010F, 2, len(make), struct.pack(e + "I", make_off)),
        (0x014A, 4, 1, struct.pack(e + "I", raw_ifd_off)),  # SubIFD
        (0x8769, 4, 1, struct.pack(e + "I", exif_off)),
    ], 0, e)
    exif = _ifd([
        (0x927C, 7, len(mn), struct.pack(e + "I", mn_off)),
    ], 0, e)
    raw_ifd = _ifd([
        (0x0100, 3, 1, struct.pack(e + "HH", w, 0)),
        (0x0101, 3, 1, struct.pack(e + "HH", h, 0)),
        (0x0102, 3, 1, struct.pack(e + "HH", bps, 0)),
        (0x0103, 3, 1, struct.pack(e + "HH", 34713, 0)),
        (0x0106, 3, 1, struct.pack(e + "HH", 32803, 0)),  # CFA
        (0x0111, 4, 1, struct.pack(e + "I", strip_off)),
        (0x0116, 3, 1, struct.pack(e + "HH", h, 0)),      # rows/strip
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
    return expect


__all__ = ["write_nef", "encode_nikon", "NIKON_TREES"]
