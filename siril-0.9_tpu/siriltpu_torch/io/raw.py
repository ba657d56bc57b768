"""DSLR RAW decoding.

Reference behavior being replaced (src/io/image_formats_libraries.c):

- ``readraw_in_cfa`` (:830-973): unpack the raw sensor plane, crop the
  masked margins, derive the Bayer pattern string from the filter
  descriptor, store as a MONO uint16 fits with ``bayer_pattern`` set,
  then ``open_raw_files`` (:975-996) vertically flips into Siril's
  bottom-up convention (``mirrorx``).
- ``readraw`` (:664-828): libraw's full postprocessing (demosaic, WB) —
  the siriltpu equivalent is decode-CFA + the 5 native demosaic methods
  (``debayer_if_needed`` semantics, src/io/conversion.c:736-781).

This environment has neither libraw nor rawpy, so the decode path is:

1. ``rawpy`` when importable (covers every libraw format), mirroring
   ``readraw_in_cfa``'s margins/pattern handling;
2. a built-in TIFF/DNG reader: uncompressed CFA (8/12/14/16-bit packed,
   strips or tiles, pure NumPy) AND lossless-JPEG compressed CFA
   (compression=7, the common real-world DNG flavor) through the native
   C++ SOF3 decoder in native/lj92.cpp.

Port of ``siriltpu.io.raw``: copied (host NumPy and the port's build of the
same native decoders, ``utils.native``), but ``read_raw`` takes the
``device`` its VNG or AHD debayer of a large frame runs on
(``ops.demosaic.debayer_buffer``).
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame

# DNG/TIFF tags
T_NEWSUBFILETYPE = 254
T_WIDTH = 256
T_HEIGHT = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_COUNTS = 325
T_SUBIFDS = 330
T_CFA_DIM = 33421
T_CFA_PATTERN = 33422
T_DNG_VERSION = 50706

PHOTOMETRIC_CFA = 32803

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8}


class _Tiff:
    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:2] == b"II":
            self.e = "<"
        elif buf[:2] == b"MM":
            self.e = ">"
        else:
            raise ValueError("not a TIFF/DNG file")
        magic = struct.unpack_from(self.e + "H", buf, 2)[0]
        # 42 = classic TIFF; 0x4F52 "RO" / 0x5352 "RS" = Olympus ORF;
        # 0x0055 = Panasonic RW2
        if magic not in (42, 0x4F52, 0x5352, 0x0055):
            raise ValueError("not a classic TIFF (BigTIFF unsupported)")
        self.first_ifd = struct.unpack_from(self.e + "I", buf, 4)[0]

    @classmethod
    def raw(cls, buf: bytes, endian: str, first_ifd: int) -> "_Tiff":
        """Header-less view for embedded IFD structures (MakerNotes
        whose offsets are relative to a base that has no TIFF magic)."""
        t = cls.__new__(cls)
        t.buf = buf
        t.e = endian
        t.first_ifd = first_ifd
        return t

    def read_ifd(self, off: int) -> Tuple[dict, int]:
        n = struct.unpack_from(self.e + "H", self.buf, off)[0]
        tags = {}
        for i in range(n):
            base = off + 2 + 12 * i
            tag, typ, count = struct.unpack_from(self.e + "HHI", self.buf,
                                                 base)
            size = _TYPE_SIZE.get(typ, 1) * count
            if size <= 4:
                raw = self.buf[base + 8: base + 8 + size]
            else:
                ptr = struct.unpack_from(self.e + "I", self.buf, base + 8)[0]
                raw = self.buf[ptr: ptr + size]
            tags[tag] = self._decode(typ, count, raw)
        nxt = struct.unpack_from(self.e + "I", self.buf, off + 2 + 12 * n)[0]
        return tags, nxt

    def _decode(self, typ: int, count: int, raw: bytes):
        if typ in (1, 6, 7):
            return np.frombuffer(raw, np.uint8, count)
        if typ == 2:
            return raw.split(b"\0")[0].decode("ascii", "replace")
        fmt = {3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}.get(typ)
        if fmt:
            return np.frombuffer(raw, np.dtype(self.e + fmt), count)
        if typ in (5, 10):  # rationals
            ints = np.frombuffer(
                raw, np.dtype(self.e + ("i" if typ == 10 else "I")),
                count * 2).astype(np.float64)
            return ints[0::2] / np.where(ints[1::2] == 0, 1, ints[1::2])
        return np.frombuffer(raw, np.uint8, len(raw))

    def all_ifds(self):
        """Walk the IFD chain plus SubIFDs, yielding tag dicts."""
        seen = set()
        stack = [self.first_ifd]
        while stack:
            off = stack.pop()
            if not off or off in seen or off >= len(self.buf):
                continue
            seen.add(off)
            tags, nxt = self.read_ifd(off)
            yield tags
            if nxt:
                stack.append(nxt)
            if T_SUBIFDS in tags:
                stack.extend(int(x) for x in np.atleast_1d(tags[T_SUBIFDS]))


def _unpack_bits(data: np.ndarray, bits: int, npix: int,
                 little: bool) -> np.ndarray:
    """Unpack a big-endian (TIFF FillOrder=1) bit-packed sample stream."""
    if bits == 8:
        return data[:npix].astype(np.uint16)
    if bits == 16:
        dt = "<u2" if little else ">u2"
        return np.frombuffer(data.tobytes(), dt, npix).astype(np.uint16)
    # 12/14/10-bit packed, MSB-first across byte boundaries
    bitarr = np.unpackbits(data)
    usable = (bitarr.size // bits) * bits
    groups = bitarr[:usable].reshape(-1, bits)[:npix]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (groups.astype(np.uint32) * weights).sum(axis=1).astype(np.uint16)


_lj92 = None


def _load_lj92():
    """ctypes handle to the native lossless-JPEG decoder (lj92.cpp)."""
    global _lj92
    if _lj92 is not None:
        return _lj92
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.lj92_decode.restype = ctypes.c_int
    lib.lj92_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    _lj92 = lib
    return _lj92


def decode_lossless_jpeg(data: bytes,
                         expect_samples: int) -> Tuple[np.ndarray, int]:
    """Decode one lossless-JPEG (SOF3) stream via the native decoder.

    Returns (rows, ncomp) where rows is (H, W*ncomp) uint16 — components
    interleaved along the row, which is exactly DNG's sample layout for
    lossless tiles. ``expect_samples`` caps the output buffer."""
    import ctypes

    lib = _load_lj92()
    if lib is None:
        raise ValueError("lossless-JPEG DNG needs the native decoder "
                         "(g++ unavailable to build lj92.cpp)")
    out = np.zeros(expect_samples, dtype=np.uint16)
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    bits = ctypes.c_int()
    rc = lib.lj92_decode(
        data, len(data), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint16)), out.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc),
        ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"lossless JPEG decode failed (code {rc})")
    total = h.value * w.value * nc.value
    return out[:total].reshape(h.value, w.value * nc.value), nc.value


_CFA_LETTERS = "RGB"  # CFAPattern values 0=R 1=G 2=B


def read_dng_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode an uncompressed CFA DNG with no external dependencies.

    Returns (cfa uint16 (H, W) top-down, bayer pattern string e.g. "RGGB").
    Raises ValueError for compressed or non-CFA files.
    """
    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    cfa_ifd = None
    try:
        for tags in t.all_ifds():
            if tags.get(T_PHOTOMETRIC) is not None and \
                    int(np.atleast_1d(tags[T_PHOTOMETRIC])[0]) == PHOTOMETRIC_CFA:
                cfa_ifd = tags
                break
    except (struct.error, IndexError) as e:
        # truncated/hostile IFD chain: normalize to the documented error
        raise ValueError(f"{path}: corrupt TIFF/DNG structure ({e})") from e
    if cfa_ifd is None:
        raise ValueError(f"{path}: no CFA image found (not a raw DNG?)")
    tags = cfa_ifd
    comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [1]))[0])
    if comp not in (1, 7):
        raise ValueError(
            f"{path}: DNG compression={comp} unsupported (built-in "
            f"decoders: 1=uncompressed, 7=lossless JPEG)")
    w = int(np.atleast_1d(tags[T_WIDTH])[0])
    h = int(np.atleast_1d(tags[T_HEIGHT])[0])
    bits = int(np.atleast_1d(tags[T_BITS])[0])
    little = t.e == "<"

    def _decode_block(data: np.ndarray, rows: int, cols: int) -> np.ndarray:
        """One strip/tile → (rows, cols) uint16."""
        if comp == 7:
            dec, _ = decode_lossless_jpeg(data.tobytes(), rows * cols)
            if dec.shape != (rows, cols):
                raise ValueError(
                    f"{path}: lossless tile is {dec.shape}, "
                    f"expected {(rows, cols)}")
            return dec
        return _unpack_bits(data, bits, rows * cols, little).reshape(
            rows, cols)

    out = np.zeros(h * w, dtype=np.uint16)
    if T_TILE_OFFSETS in tags:
        tw = int(np.atleast_1d(tags[T_TILE_WIDTH])[0])
        th = int(np.atleast_1d(tags[T_TILE_LENGTH])[0])
        offs = np.atleast_1d(tags[T_TILE_OFFSETS]).astype(np.int64)
        cnts = np.atleast_1d(tags[T_TILE_COUNTS]).astype(np.int64)
        out2 = out.reshape(h, w)
        ti = 0
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                data = np.frombuffer(buf, np.uint8, int(cnts[ti]),
                                     int(offs[ti]))
                tile = _decode_block(data, th, tw)
                out2[ty: ty + th, tx: tx + tw] = \
                    tile[: min(th, h - ty), : min(tw, w - tx)]
                ti += 1
    else:
        offs = np.atleast_1d(tags[T_STRIP_OFFSETS]).astype(np.int64)
        cnts = np.atleast_1d(tags[T_STRIP_COUNTS]).astype(np.int64)
        rps = int(np.atleast_1d(tags.get(T_ROWS_PER_STRIP, [h]))[0])
        pos = 0
        for si in range(len(offs)):
            rows = min(rps, h - si * rps)
            data = np.frombuffer(buf, np.uint8, int(cnts[si]), int(offs[si]))
            out[pos: pos + rows * w] = _decode_block(data, rows, w).ravel()
            pos += rows * w
    cfa = out.reshape(h, w)

    dim = np.atleast_1d(tags.get(T_CFA_DIM, np.array([2, 2])))
    pat = np.atleast_1d(tags.get(T_CFA_PATTERN, np.array([0, 1, 1, 2])))
    if int(dim[0]) != 2 or int(dim[1]) != 2:
        raise ValueError(f"{path}: non-2x2 CFA pattern unsupported "
                         f"(X-Trans etc.), like the reference "
                         f"(image_formats_libraries.c:894-900)")
    pattern = "".join(_CFA_LETTERS[int(v)] for v in pat[:4])
    return cfa, pattern


def read_tiffraw_cfa(path: str, ext: str) -> Tuple[np.ndarray, str]:
    """Generic TIFF-container raw with UNCOMPRESSED packed strips — the
    layout of uncompressed NEF/ARW/PEF/ORF variants (vendors offering a
    "14-bit uncompressed" mode store plain TIFF strips of MSB-packed
    samples in a SubIFD). The raw IFD is the largest strip-based IFD
    with compression 1 and 10/12/14/16-bit samples; the Bayer pattern
    comes from the reference's per-vendor table (conversion.c:51-74 —
    the reference trusts that table too, use_bayer_header semantics).

    Compressed vendor formats (NEF lossy/lossless trees, Sony ARW
    cRAW) still need libraw/rawpy — raised as a clear error.
    """
    from siriltpu_torch.io.conversion import RAW_EXTENSIONS

    pattern = RAW_EXTENSIONS.get(ext)
    if not pattern:
        raise ValueError(f"{path}: no Bayer pattern known for .{ext}")
    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    best = None
    best_px = 0
    try:
        for tags in t.all_ifds():
            if T_STRIP_OFFSETS not in tags or T_WIDTH not in tags:
                continue
            comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [1]))[0])
            bits = int(np.atleast_1d(tags.get(T_BITS, [0]))[0])
            w = int(np.atleast_1d(tags[T_WIDTH])[0])
            h = int(np.atleast_1d(tags[T_HEIGHT])[0])
            if comp == 1 and bits in (10, 12, 14, 16) and w * h > best_px:
                best, best_px = tags, w * h
    except (struct.error, IndexError) as e:
        raise ValueError(f"{path}: corrupt TIFF structure ({e})") from e
    if best is None:
        raise ValueError(
            f"{path}: no uncompressed raw IFD found — this .{ext} uses a "
            f"vendor compression that needs rawpy/libraw")
    tags = best
    w = int(np.atleast_1d(tags[T_WIDTH])[0])
    h = int(np.atleast_1d(tags[T_HEIGHT])[0])
    bits = int(np.atleast_1d(tags[T_BITS])[0])
    offs = np.atleast_1d(tags[T_STRIP_OFFSETS]).astype(np.int64)
    cnts = np.atleast_1d(tags[T_STRIP_COUNTS]).astype(np.int64)
    rps = int(np.atleast_1d(tags.get(T_ROWS_PER_STRIP, [h]))[0])
    out = np.zeros(h * w, dtype=np.uint16)
    pos = 0
    for si in range(len(offs)):
        rows = min(rps, h - si * rps)
        data = np.frombuffer(buf, np.uint8, int(cnts[si]), int(offs[si]))
        out[pos: pos + rows * w] = _unpack_bits(
            data, bits, rows * w, t.e == "<").ravel()
        pos += rows * w
    return out.reshape(h, w), pattern


# Sony ARW (compressed "cRAW"/ARW2) support
T_SONY_CURVE = 0x7010       # SR2 tone-curve breakpoints (4 shorts)
SONY_ARW2_COMPRESSION = 32767


def sony_tone_curve(breaks=None) -> np.ndarray:
    """The Sony cRAW decompression tone curve.

    Piecewise-linear with slopes 1,2,4,8,16 between breakpoints taken
    from the SR2 private tag 0x7010 (stored raw; consumers apply
    ``>>2 & 0xfff``), defaulting to [0,0,0,0,0,4095] (all-16 slope)
    when the tag is absent — the documented dcraw/libraw semantics for
    ``sony_arw2_load_raw``'s ``curve[]``.
    """
    sc = [0, 0, 0, 0, 0, 4095]
    if breaks is not None:
        vals = [int(b) >> 2 & 0xFFF for b in np.atleast_1d(breaks)[:4]]
        sc = [0] + vals + [4095]
    idx = np.arange(0x1000)
    slope = np.zeros(0x1000, np.uint32)
    for i in range(5):
        slope[(idx > sc[i]) & (idx <= sc[i + 1])] = 1 << i
    slope[idx > sc[5]] = 0  # beyond the last breakpoint: flat (unused)
    return np.cumsum(slope, dtype=np.uint32)


def decode_arw2(strip: bytes, h: int, w: int,
                curve: np.ndarray) -> np.ndarray:
    """Decode Sony ARW2 ("cRAW") compressed sensor data, vectorized.

    Layout (the documented dcraw ``sony_arw2_load_raw`` bitstream): one
    byte per pixel on average; each 16-byte little-endian block encodes
    16 pixels of ONE Bayer column parity spanning 32 raster columns —
    an 11-bit max, 11-bit min, their 4-bit indices, and fourteen 7-bit
    deltas ``(pix-min)>>sh`` where ``sh`` is the smallest shift in 0..4
    with ``0x80<<sh > max-min``. Even blocks fill even columns of the
    32-column span, odd blocks the odd columns. Output pixel =
    ``curve[pix<<1] >> 2``.

    The reference loop bound (``col < raw_width-30``) decodes full
    32-column pairs PLUS a lone even block when ``w % 32 == 31`` (its
    16 even columns reach w-1); any other trailing columns are left 0.
    """
    npix = h * w
    data = np.frombuffer(strip, np.uint8, min(len(strip), npix))
    if data.size < npix:
        raise ValueError(f"ARW2 strip too short: {data.size} < {npix}")
    rows = data.reshape(h, w)
    extra = 1 if w % 32 == 31 else 0
    nb = (w // 32) * 2 + extra  # decoded blocks per row
    if nb == 0:
        return np.zeros((h, w), np.uint16)
    # 18-byte windows per block: the 7-bit fields start at bit 30 and the
    # byte-wise reads may touch up to 2 bytes past the block (the
    # reference over-reads into the next block / its +1 padding byte).
    padded = np.concatenate(
        [rows, np.zeros((h, 2), np.uint8)], axis=1)
    starts = np.arange(nb) * 16
    win = padded[:, starts[:, None] + np.arange(18)[None, :]]
    blk = win.reshape(h * nb, 18).astype(np.uint32)

    val = blk[:, 0] | blk[:, 1] << 8 | blk[:, 2] << 16 | blk[:, 3] << 24
    mx = val & 0x7FF
    mn = (val >> 11) & 0x7FF
    imax = (val >> 22) & 0xF
    imin = (val >> 26) & 0xF
    d = mx.astype(np.int64) - mn.astype(np.int64)
    sh = np.zeros(blk.shape[0], np.uint32)
    for s in range(4):
        sh += ((0x80 << s) <= d)

    # fifteen possible 7-bit fields (the 15th only consumed when
    # imax == imin, exactly like the reference's bit counter)
    fields = np.empty((blk.shape[0], 15), np.uint32)
    for k in range(15):
        bit = 30 + 7 * k
        b, s = bit >> 3, bit & 7
        fields[:, k] = ((blk[:, b] | blk[:, b + 1] << 8) >> s) & 0x7F

    i_idx = np.arange(16)[None, :]
    is_max = i_idx == imax[:, None]
    is_min = (i_idx == imin[:, None]) & ~is_max
    special = is_max | is_min
    k_for_i = np.cumsum(~special, axis=1) - 1
    packed = np.take_along_axis(fields, np.maximum(k_for_i, 0), axis=1)
    pix = np.minimum((packed << sh[:, None]) + mn[:, None], 0x7FF)
    pix = np.where(is_max, mx[:, None],
                   np.where(is_min, mn[:, None], pix)).astype(np.int64)

    out = (curve[np.minimum(pix << 1, 0xFFF)] >> 2).astype(np.uint16)
    img = np.zeros((h, w), np.uint16)
    pairs = (nb - extra) // 2
    gg = out.reshape(h, nb, 16)
    if pairs:
        g = gg[:, : 2 * pairs].reshape(h, pairs, 2, 16)
        cols = (32 * np.arange(pairs)[:, None] +
                2 * np.arange(16)[None, :]).ravel()
        img[:, cols] = g[:, :, 0, :].reshape(h, -1)       # even blocks
        img[:, cols + 1] = g[:, :, 1, :].reshape(h, -1)   # odd blocks
    if extra:
        ec = 32 * pairs + 2 * np.arange(16)               # lone even block
        img[:, ec] = gg[:, -1]
    return img


def read_arw2_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a compressed Sony ARW ("cRAW"/ARW2, compression 32767,
    one byte per pixel) natively. The reference reaches these through
    libraw (``readraw_in_cfa``, image_formats_libraries.c:830); this
    reproduces the documented dcraw bitstream + SR2 tone curve (see
    ``decode_arw2``/``sony_tone_curve``). Pattern: RGGB from the
    per-vendor table (conversion.c:70)."""
    from siriltpu_torch.io.conversion import RAW_EXTENSIONS

    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    raw_tags = None
    curve_breaks = None
    try:
        for tags in t.all_ifds():
            if T_SONY_CURVE in tags and curve_breaks is None:
                curve_breaks = tags[T_SONY_CURVE]
            comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [0]))[0])
            if comp != SONY_ARW2_COMPRESSION or T_STRIP_OFFSETS not in tags:
                continue
            w = int(np.atleast_1d(tags[T_WIDTH])[0])
            h = int(np.atleast_1d(tags[T_HEIGHT])[0])
            cnt = int(np.atleast_1d(tags[T_STRIP_COUNTS]).sum())
            if cnt >= w * h:  # ARW2 signature: one byte per pixel
                raw_tags = tags
    except (struct.error, IndexError) as e:
        raise ValueError(f"{path}: corrupt ARW structure ({e})") from e
    if raw_tags is None:
        raise ValueError(
            f"{path}: no ARW2 raw IFD (compression 32767, 1 byte/px) "
            f"found — other Sony compressions need rawpy/libraw")
    w = int(np.atleast_1d(raw_tags[T_WIDTH])[0])
    h = int(np.atleast_1d(raw_tags[T_HEIGHT])[0])
    off = int(np.atleast_1d(raw_tags[T_STRIP_OFFSETS])[0])
    cnt = int(np.atleast_1d(raw_tags[T_STRIP_COUNTS]).sum())
    cfa = decode_arw2(buf[off: off + cnt], h, w,
                      sony_tone_curve(curve_breaks))
    return cfa, RAW_EXTENSIONS["arw"]


# Canon CR2 container tags
T_EXIF_IFD = 0x8769
T_MAKERNOTE = 0x927C
T_CR2_SLICES = 0xC640       # [count, slice_width, last_slice_width]
T_CANON_SENSORINFO = 0x00E0  # shorts: [n, W, H, ?, ?, left, top, right, bottom]


def read_cr2_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a Canon CR2 raw natively: TIFF container + lossless-JPEG
    (SOF3) strip through native/lj92.cpp, then the CR2 column-slice
    reassembly and the Canon SensorInfo active-area crop.

    The reference decodes CR2 via libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); without libraw this reproduces the
    documented dcraw CR2 layout: the raw lives in the LAST chained IFD
    (compression = 6, old-JPEG) as one lossless-JPEG strip whose decoded
    rows, W_jpeg x ncomp samples wide, fill the sensor raster in
    VERTICAL SLICES given by tag 0xc640 ([count, width, last_width]);
    the active area is cut by the Canon MakerNote SensorInfo borders
    (tag 0xe0: left/top/right/bottom, inclusive). The Bayer pattern is
    the reference's per-vendor table value for cr2: RGGB
    (conversion.c:53).

    Returns (cfa uint16 (H, W) top-down, "RGGB").
    """
    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    if buf[8:10] != b"CR":
        raise ValueError(f"{path}: not a CR2 (missing CR magic)")

    raw_tags = None
    exif_off = None
    try:
        for tags in t.all_ifds():
            if T_EXIF_IFD in tags and exif_off is None:
                exif_off = int(np.atleast_1d(tags[T_EXIF_IFD])[0])
            comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [0]))[0])
            if comp == 6 and T_STRIP_OFFSETS in tags:
                raw_tags = tags
    except (struct.error, IndexError) as e:
        raise ValueError(f"{path}: corrupt CR2 structure ({e})") from e
    if raw_tags is None:
        raise ValueError(f"{path}: no lossless-JPEG raw IFD found")

    off = int(np.atleast_1d(raw_tags[T_STRIP_OFFSETS])[0])
    cnt = int(np.atleast_1d(raw_tags[T_STRIP_COUNTS])[0])
    blob = buf[off: off + cnt]
    # size the output from the SOF3 frame header (FFC3: P, H, W, Nf)
    sof = blob.find(b"\xff\xc3")
    if sof < 0 or sof + 10 > len(blob):
        raise ValueError(f"{path}: raw strip has no SOF3 frame")
    _, jph, jpw, jpn = struct.unpack_from(">BHHB", blob, sof + 4)
    dec, ncomp = decode_lossless_jpeg(blob, jph * jpw * jpn)
    jh, jw = dec.shape  # jw = jpeg width * ncomp = sensor row samples
    flat = dec.ravel()

    slices = np.atleast_1d(raw_tags.get(T_CR2_SLICES, np.array([], np.uint16)))
    if slices.size >= 3 and int(slices[0]) > 0:
        n_sl, w_sl, w_last = int(slices[0]), int(slices[1]), int(slices[2])
        if n_sl * w_sl + w_last != jw:
            raise ValueError(
                f"{path}: slice table {n_sl}x{w_sl}+{w_last} != row "
                f"width {jw}")
        raster = np.empty((jh, jw), np.uint16)
        pos = 0
        col = 0
        for k in range(n_sl + 1):
            wk = w_sl if k < n_sl else w_last
            raster[:, col: col + wk] = \
                flat[pos: pos + jh * wk].reshape(jh, wk)
            pos += jh * wk
            col += wk
    else:
        raster = flat.reshape(jh, jw)

    # Canon SensorInfo crop (EXIF IFD -> MakerNote, an IFD with
    # absolute offsets; borders inclusive)
    if exif_off:
        try:
            exif_tags, _ = t.read_ifd(exif_off)
            mn = exif_tags.get(T_MAKERNOTE)
            if mn is not None:
                # locate the makernote bytes to get their file offset:
                # re-read the EXIF IFD entries raw to find the pointer
                n = struct.unpack_from(t.e + "H", buf, exif_off)[0]
                mn_off = None
                for i in range(n):
                    base = exif_off + 2 + 12 * i
                    tag, typ, count = struct.unpack_from(
                        t.e + "HHI", buf, base)
                    if tag == T_MAKERNOTE:
                        mn_off = struct.unpack_from(
                            t.e + "I", buf, base + 8)[0]
                        break
                if mn_off:
                    mk_tags, _ = t.read_ifd(mn_off)
                    si = np.atleast_1d(
                        mk_tags.get(T_CANON_SENSORINFO, np.array([])))
                    if si.size >= 9:
                        left, top = int(si[5]), int(si[6])
                        right, bottom = int(si[7]), int(si[8])
                        if 0 <= left < right < jw and 0 <= top < bottom < jh:
                            raster = raster[top: bottom + 1,
                                            left: right + 1]
        except (struct.error, IndexError):
            pass  # no/foreign makernote: keep the full raster

    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return np.ascontiguousarray(raster), RAW_EXTENSIONS["cr2"]


# Nikon NEF (compression 34713) support
NIKON_NEF_COMPRESSION = 34713
T_NIKON_LINEARIZATION = 0x0096  # MakerNote tag: the "meta" blob

_nikon = None


def _load_nikon():
    """ctypes handle to the native NEF decoder (nikon.cpp)."""
    global _nikon
    if _nikon is not None:
        return _nikon
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.nikon_decompress.restype = ctypes.c_int
    lib.nikon_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16)]
    _nikon = lib
    return _nikon


def _nikon_makernote_meta(buf: bytes, t: "_Tiff",
                          exif_off: int) -> Tuple[bytes, str]:
    """Extract the Nikon MakerNote linearization blob (tag 0x96).

    Modern NEFs embed a whole TIFF structure inside the MakerNote
    ("Nikon\\0" + version + TIFF header at +10, offsets relative to that
    header); the blob's shorts use the embedded header's byte order.
    Returns (meta bytes, endianness) or raises ValueError.
    """
    exif_tags, _ = t.read_ifd(exif_off)
    mn = exif_tags.get(T_MAKERNOTE)
    if mn is None:
        raise ValueError("no MakerNote in the EXIF IFD")
    mn = bytes(np.atleast_1d(mn).astype(np.uint8).tobytes())
    if not mn.startswith(b"Nikon\x00"):
        raise ValueError("MakerNote is not Nikon-typed")
    inner = _Tiff(mn[10:])
    tags, _ = inner.read_ifd(inner.first_ifd)
    meta = tags.get(T_NIKON_LINEARIZATION)
    if meta is None:
        raise ValueError("MakerNote has no linearization table (0x96)")
    return np.atleast_1d(meta).astype(np.uint8).tobytes(), inner.e


def _nef_meta_decode(meta: bytes, e: str, bps: int):
    """Decode the tag-0x96 blob into (tree index, vpred[4], curve LUT,
    split row) following the documented dcraw layout: version bytes,
    (optional 2110-byte skip for the 0x49/0x58 bodies), 4 vertical
    predictors, a curve-size short, then either sampled curve points
    expanded by integer linear interpolation (lossy v0x44.20, split row
    at blob offset 562) or a direct curve table; the lossless flavor
    (0x46) keeps the identity curve."""
    ver0, ver1 = meta[0], meta[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110
    u2 = np.dtype(e + "u2")
    vpred = np.frombuffer(meta, u2, 4, pos).astype(np.int16)
    pos += 8
    csize = struct.unpack_from(e + "H", meta, pos)[0]
    pos += 2
    maxv = (1 << bps) & 0x7fff
    step = maxv // (csize - 1) if csize > 1 else 0
    tree = 2 if ver0 == 0x46 else 0
    if bps == 14:
        tree += 3
    curve = np.arange(65536, dtype=np.int64)
    split = 0
    if ver0 == 0x44 and ver1 == 0x20 and step > 0:
        pts = np.frombuffer(meta, u2, csize, pos).astype(np.int64)
        cp = curve.copy()
        cp[np.arange(csize) * step] = pts
        i = np.arange(maxv, dtype=np.int64)
        lo = i - i % step
        f = i % step
        curve[:maxv] = (cp[lo] * (step - f) + cp[lo + step] * f) // step
        split = struct.unpack_from(e + "H", meta, 562)[0]
    elif ver0 != 0x46 and csize <= 0x4001:
        n = min(csize, max(0, (len(meta) - pos) // 2))
        curve[:n] = np.frombuffer(meta, u2, n, pos).astype(np.int64)
    return tree, vpred, curve, split


def read_nef_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a compressed Nikon NEF (compression 34713 — the lossy
    type-2 and lossless flavors) natively through native/nikon.cpp.

    The reference reaches NEF through libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); this reproduces the documented
    dcraw/libraw pipeline: the MakerNote's tag-0x96 blob supplies the
    version (tree selection), vertical predictors, tone curve and split
    row; the strip is an MSB-first Huffman/differential bitstream; the
    decoded predictor values index the curve after a 0..0x3fff clip.
    Pattern: RGGB from the per-vendor table (conversion.c:63).
    """
    import ctypes

    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    raw_tags = None
    exif_off = None
    try:
        for tags in t.all_ifds():
            if T_EXIF_IFD in tags and exif_off is None:
                exif_off = int(np.atleast_1d(tags[T_EXIF_IFD])[0])
            comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [0]))[0])
            if comp != NIKON_NEF_COMPRESSION or T_STRIP_OFFSETS not in tags:
                continue
            w = int(np.atleast_1d(tags[T_WIDTH])[0])
            h = int(np.atleast_1d(tags[T_HEIGHT])[0])
            if raw_tags is None or w * h > (
                    int(np.atleast_1d(raw_tags[T_WIDTH])[0]) *
                    int(np.atleast_1d(raw_tags[T_HEIGHT])[0])):
                raw_tags = tags
    except (struct.error, IndexError) as exc:
        raise ValueError(f"{path}: corrupt NEF structure ({exc})") from exc
    if raw_tags is None:
        raise ValueError(
            f"{path}: no compressed NEF raw IFD (compression 34713) found")
    if exif_off is None:
        raise ValueError(f"{path}: NEF has no EXIF IFD (need the "
                         f"MakerNote linearization table)")
    try:
        meta, me = _nikon_makernote_meta(buf, t, exif_off)
    except (struct.error, IndexError, ValueError) as exc:
        raise ValueError(f"{path}: cannot read the Nikon MakerNote "
                         f"linearization table ({exc})") from exc

    w = int(np.atleast_1d(raw_tags[T_WIDTH])[0])
    h = int(np.atleast_1d(raw_tags[T_HEIGHT])[0])
    bps = int(np.atleast_1d(raw_tags.get(T_BITS, [12]))[0])
    tree, vpred, curve, split = _nef_meta_decode(meta, me, bps)
    off = int(np.atleast_1d(raw_tags[T_STRIP_OFFSETS])[0])
    cnt = int(np.atleast_1d(raw_tags[T_STRIP_COUNTS]).sum())
    strip = buf[off: off + cnt]

    lib = _load_nikon()
    if lib is None:
        raise ValueError("compressed NEF needs the native decoder "
                         "(g++ unavailable to build nikon.cpp)")
    hpred = np.zeros((h, w), np.int16)
    rc = lib.nikon_decompress(
        strip, len(strip), h, w, tree, split,
        vpred.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        hpred.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if rc != 0:
        raise ValueError(f"{path}: NEF bitstream decode failed (code {rc})")
    cfa = curve[np.clip(hpred.astype(np.int64), 0, 0x3fff)].astype(np.uint16)

    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return cfa, RAW_EXTENSIONS["nef"]


# Pentax PEF (compression 65535) support
PENTAX_PEF_COMPRESSION = 65535
T_PENTAX_HUFFMAN = 0x0220  # MakerNote tag: the compression code table

_pentax = None


def _load_pentax():
    """ctypes handle to the native PEF decoder (pentax.cpp)."""
    global _pentax
    if _pentax is not None:
        return _pentax
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.pentax_decompress.restype = ctypes.c_int
    lib.pentax_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int16)]
    _pentax = lib
    return _pentax


def _makernote_location(buf: bytes, t: "_Tiff",
                        exif_off: int) -> Tuple[bytes, int]:
    """(MakerNote bytes, absolute file offset) from the EXIF IFD."""
    n = struct.unpack_from(t.e + "H", buf, exif_off)[0]
    for i in range(n):
        base = exif_off + 2 + 12 * i
        tag, typ, count = struct.unpack_from(t.e + "HHI", buf, base)
        if tag != T_MAKERNOTE:
            continue
        size = _TYPE_SIZE.get(typ, 1) * count
        if size <= 4:
            return buf[base + 8: base + 8 + size], base + 8
        off = struct.unpack_from(t.e + "I", buf, base + 8)[0]
        return buf[off: off + size], off
    raise ValueError("no MakerNote in the EXIF IFD")


def _pentax_huffman_meta(buf: bytes, t: "_Tiff",
                         exif_off: int) -> Tuple[bytes, str]:
    """Extract the Pentax MakerNote code-table blob (tag 0x220).

    Two documented MakerNote flavors: modern "PENTAX " (byte order at
    +8, an IFD at +10 with offsets relative to the MakerNote start) and
    the older "AOC\\0" (IFD at +6, absolute file offsets, file order).
    Returns (meta bytes, endianness of its shorts).
    """
    mn, mn_off = _makernote_location(buf, t, exif_off)
    if mn.startswith(b"PENTAX "):
        e = "<" if mn[8:10] == b"II" else ">"
        inner = _Tiff.raw(mn, e, 10)
        tags, _ = inner.read_ifd(10)
    elif mn.startswith(b"AOC\x00"):
        e = t.e
        inner = _Tiff.raw(buf, e, mn_off + 6)
        tags, _ = inner.read_ifd(mn_off + 6)
    else:
        raise ValueError("MakerNote is not Pentax-typed")
    meta = tags.get(T_PENTAX_HUFFMAN)
    if meta is None:
        raise ValueError("MakerNote has no Huffman table (0x220)")
    return np.atleast_1d(meta).astype(np.uint8).tobytes(), e


def read_pef_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a compressed Pentax PEF (compression 65535) natively
    through native/pentax.cpp.

    The reference reaches PEF through libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); this reproduces the documented
    dcraw/libraw pipeline: MakerNote tag 0x220 carries the Huffman
    table as (12-bit start code, length) pairs — the residual category
    is the table position — and the strip is an MSB-first bitstream of
    JPEG-sign-extended residuals through the Nikon-style column-pair
    predictor scheme (zero-seeded). Pattern: BGGR from the per-vendor
    table (conversion.c:65).
    """
    import ctypes

    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    raw_tags = None
    exif_off = None
    try:
        for tags in t.all_ifds():
            if T_EXIF_IFD in tags and exif_off is None:
                exif_off = int(np.atleast_1d(tags[T_EXIF_IFD])[0])
            comp = int(np.atleast_1d(tags.get(T_COMPRESSION, [0]))[0])
            if comp == PENTAX_PEF_COMPRESSION and T_STRIP_OFFSETS in tags:
                raw_tags = tags
    except (struct.error, IndexError) as exc:
        raise ValueError(f"{path}: corrupt PEF structure ({exc})") from exc
    if raw_tags is None:
        raise ValueError(
            f"{path}: no compressed PEF raw IFD (compression 65535) found")
    if exif_off is None:
        raise ValueError(f"{path}: PEF has no EXIF IFD (need the "
                         f"MakerNote Huffman table)")
    try:
        meta, me = _pentax_huffman_meta(buf, t, exif_off)
    except (struct.error, IndexError, ValueError) as exc:
        raise ValueError(f"{path}: cannot read the Pentax MakerNote "
                         f"Huffman table ({exc})") from exc

    # blob: short -> dep = (v+12)&15 categories; 12 skipped bytes; dep
    # 12-bit start codes (shorts); dep code lengths (bytes)
    dep = (struct.unpack_from(me + "H", meta, 0)[0] + 12) & 15
    starts = np.frombuffer(meta, np.dtype(me + "u2"), dep, 14).copy()
    lens = np.frombuffer(meta, np.uint8, dep, 14 + 2 * dep).copy()

    w = int(np.atleast_1d(raw_tags[T_WIDTH])[0])
    h = int(np.atleast_1d(raw_tags[T_HEIGHT])[0])
    off = int(np.atleast_1d(raw_tags[T_STRIP_OFFSETS])[0])
    cnt = int(np.atleast_1d(raw_tags[T_STRIP_COUNTS]).sum())
    strip = buf[off: off + cnt]

    lib = _load_pentax()
    if lib is None:
        raise ValueError("compressed PEF needs the native decoder "
                         "(g++ unavailable to build pentax.cpp)")
    out = np.zeros((h, w), np.int16)
    rc = lib.pentax_decompress(
        strip, len(strip), h, w,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dep,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if rc != 0:
        raise ValueError(f"{path}: PEF bitstream decode failed (code {rc})")

    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return out.view(np.uint16), RAW_EXTENSIONS["pef"]


# Olympus ORF support
_olympus = None


def _load_olympus():
    """ctypes handle to the native ORF decoder (olympus.cpp)."""
    global _olympus
    if _olympus is not None:
        return _olympus
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.olympus_decompress.restype = ctypes.c_int
    lib.olympus_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16)]
    _olympus = lib
    return _olympus


def read_orf_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a compressed Olympus ORF natively through
    native/olympus.cpp.

    The reference reaches ORF through libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); this reproduces the documented
    dcraw/libraw pipeline (olympus_load_raw): the container is TIFF
    with the "RO"/"RS" magic, the raw strip starts 7 bytes before an
    MSB-first bitstream of sign+low bits, unary-coded highs with a
    12-zeros escape, and carry-adaptive residual widths feeding a
    gradient-adaptive same-plane predictor. Pattern: GRBG from the
    per-vendor table (conversion.c:64). (Uncompressed ORFs flow
    through read_tiffraw_cfa instead.)
    """
    import ctypes

    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    raw_tags = None
    try:
        for tags in t.all_ifds():
            if T_STRIP_OFFSETS not in tags or T_WIDTH not in tags:
                continue
            w = int(np.atleast_1d(tags[T_WIDTH])[0])
            h = int(np.atleast_1d(tags[T_HEIGHT])[0])
            if raw_tags is None or w * h > (
                    int(np.atleast_1d(raw_tags[T_WIDTH])[0]) *
                    int(np.atleast_1d(raw_tags[T_HEIGHT])[0])):
                raw_tags = tags
    except (struct.error, IndexError) as exc:
        raise ValueError(f"{path}: corrupt ORF structure ({exc})") from exc
    if raw_tags is None:
        raise ValueError(f"{path}: no raw IFD with strips found")

    w = int(np.atleast_1d(raw_tags[T_WIDTH])[0])
    h = int(np.atleast_1d(raw_tags[T_HEIGHT])[0])
    off = int(np.atleast_1d(raw_tags[T_STRIP_OFFSETS])[0])
    cnt = int(np.atleast_1d(raw_tags[T_STRIP_COUNTS]).sum())
    strip = buf[off + 7: off + cnt]  # bitstream starts 7 bytes in

    lib = _load_olympus()
    if lib is None:
        raise ValueError("compressed ORF needs the native decoder "
                         "(g++ unavailable to build olympus.cpp)")
    out = np.zeros((h, w), np.uint16)
    rc = lib.olympus_decompress(
        strip, len(strip), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"{path}: ORF bitstream decode failed (code {rc})")

    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return out, RAW_EXTENSIONS["orf"]


# Panasonic RW2 support
T_PANA_SENSOR_W = 0x0002
T_PANA_SENSOR_H = 0x0003
T_PANA_TOP = 0x0004
T_PANA_LEFT = 0x0005
T_PANA_BOTTOM = 0x0006
T_PANA_RIGHT = 0x0007
T_PANA_RAW_OFFSET = 0x0118
PANA_LOAD_FLAGS = 0x2008

_panasonic = None


def _load_panasonic():
    """ctypes handle to the native RW2 decoder (panasonic.cpp)."""
    global _panasonic
    if _panasonic is not None:
        return _panasonic
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.panasonic_decompress.restype = ctypes.c_int
    lib.panasonic_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    _panasonic = lib
    return _panasonic


def read_rw2_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a Panasonic RW2 (classic 12-bit compressed scheme)
    natively through native/panasonic.cpp.

    The reference reaches RW2 through libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); this reproduces the documented
    dcraw/libraw pipeline (panasonic_load_raw): sensor geometry from
    the Panasonic IFD0 tags (2/3 sensor dims, 4-7 active borders),
    the raw stream at tag 0x118 in 0x4000-byte tail-rotated blocks
    (load_flags 0x2008), 14-pixel lane-interleaved predictor groups.
    Pattern: BGGR from the per-vendor table (conversion.c:66).
    """
    import ctypes

    with open(path, "rb") as f:
        buf = f.read()
    t = _Tiff(buf)
    tags0, _ = t.read_ifd(t.first_ifd)
    for need in (T_PANA_SENSOR_W, T_PANA_SENSOR_H, T_PANA_RAW_OFFSET):
        if need not in tags0:
            raise ValueError(f"{path}: not a Panasonic RW2 raw IFD "
                             f"(missing tag {need:#x})")
    w = int(np.atleast_1d(tags0[T_PANA_SENSOR_W])[0])
    h = int(np.atleast_1d(tags0[T_PANA_SENSOR_H])[0])
    off = int(np.atleast_1d(tags0[T_PANA_RAW_OFFSET])[0])
    strip = buf[off:]  # runs to EOF (no byte-count tag in RW2)

    lib = _load_panasonic()
    if lib is None:
        raise ValueError("RW2 needs the native decoder "
                         "(g++ unavailable to build panasonic.cpp)")
    out = np.zeros((h, w), np.uint16)
    rc = lib.panasonic_decompress(
        strip, len(strip), h, w, PANA_LOAD_FLAGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"{path}: RW2 bitstream decode failed (code {rc})")

    # active-area crop from the border tags (top/bottom rows,
    # left/right cols; half-open like the documented consumer)
    top = int(np.atleast_1d(tags0.get(T_PANA_TOP, [0]))[0])
    left = int(np.atleast_1d(tags0.get(T_PANA_LEFT, [0]))[0])
    bottom = int(np.atleast_1d(tags0.get(T_PANA_BOTTOM, [h]))[0])
    right = int(np.atleast_1d(tags0.get(T_PANA_RIGHT, [w]))[0])
    if 0 <= top < bottom <= h and 0 <= left < right <= w:
        out = np.ascontiguousarray(out[top:bottom, left:right])

    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return out, RAW_EXTENSIONS["rw2"]


def read_mrw_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a Minolta MRW raw. The reference reaches MRW through
    libraw (``readraw_in_cfa``, image_formats_libraries.c:830); this
    parses the documented container directly (dcraw ``parse_minolta``):
    a big-endian ``\\0MRM`` meta block of tagged sub-blocks —
    ``\\0PRD`` carries the sensor geometry (8-byte version string,
    then sensor height/width u16, image height/width u16, dataSize u8,
    pixelSize u8, storageMethod u8 0x52=unpacked/0x59=packed) — with
    the sample stream following the meta block: 12-bit MSB-packed
    (packed) or 16-bit big-endian words (unpacked). Pattern: RGGB from
    the per-vendor table (conversion.c:62).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"\x00MRM":
        raise ValueError(f"{path}: not a Minolta MRW file")
    (meta_len,) = struct.unpack(">I", buf[4:8])
    data_off = meta_len + 8
    pos = 8
    high = wide = None
    data_size, storage = 12, 0x59
    while pos + 8 <= min(data_off, len(buf)):
        tag = buf[pos: pos + 4]
        (blen,) = struct.unpack(">I", buf[pos + 4: pos + 8])
        body = pos + 8
        if tag == b"\x00PRD" and body + 19 <= len(buf):
            high, wide = struct.unpack(">HH", buf[body + 8: body + 12])
            data_size = buf[body + 16]
            storage = buf[body + 18]
        pos = body + blen
    if not high or not wide:
        raise ValueError(f"{path}: MRW meta block has no PRD geometry")
    if storage == 0x52:
        data_size = 16
    elif storage != 0x59:
        raise ValueError(f"{path}: unknown MRW storage method "
                         f"{storage:#x}")
    if data_size not in (12, 16):
        raise ValueError(f"{path}: unsupported MRW dataSize {data_size}")
    need = (high * wide * data_size + 7) // 8
    data = np.frombuffer(buf, np.uint8, need, data_off)
    cfa = _unpack_bits(data, data_size, high * wide,
                       little=False).reshape(high, wide)
    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return np.ascontiguousarray(cfa), RAW_EXTENSIONS["mrw"]


_crw = None


def _load_crw():
    """ctypes handle to the native CRW decoder (canon_crw.cpp)."""
    global _crw
    if _crw is not None:
        return _crw
    import ctypes

    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.crw_decompress.restype = ctypes.c_int
    lib.crw_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint16)]
    lib.crw_leaf_code.restype = ctypes.c_uint
    lib.crw_leaf_code.argtypes = [ctypes.c_int, ctypes.c_int]
    _crw = lib
    return _crw


def _ciff_tags(buf: bytes, heap_off: int, length: int,
               tags: dict, depth: int = 0) -> None:
    """Walk a CIFF heap: the last 4 bytes of the heap give the directory
    offset (heap-relative); the directory is a u16 record count then
    10-byte records (type u16, length u32, offset u32). Storage bits
    0x4000 mean the 8 value bytes live in the record itself; subheaps
    (type >> 8 in 0x28/0x30) recurse."""
    if depth > 4 or length < 4 or heap_off + length > len(buf):
        return
    (dstart,) = struct.unpack_from("<I", buf, heap_off + length - 4)
    doff = heap_off + dstart
    if doff + 2 > len(buf):
        return
    (nrec,) = struct.unpack_from("<H", buf, doff)
    if nrec > 1024:
        return
    for i in range(nrec):
        base = doff + 2 + 10 * i
        if base + 10 > len(buf):
            return
        typ, ln, ro = struct.unpack_from("<HII", buf, base)
        if typ & 0xc000 == 0x4000:
            tags[typ & 0x3fff] = buf[base + 2: base + 10]
            continue
        aoff = heap_off + ro
        if (typ >> 8) in (0x28, 0x30):
            _ciff_tags(buf, aoff, ln, tags, depth + 1)
        else:
            tags[typ] = (aoff, ln)


def _crw_has_lowbits(buf: bytes) -> bool:
    """canon_has_lowbits heuristic: scan bytes [540, 0x4000): a 0xff
    followed by 0x00 means the 2-bit low-order plane is present; a 0xff
    followed by anything else (and never by 0x00) means it is absent;
    no 0xff at all defaults to present."""
    win = np.frombuffer(buf, np.uint8, max(0, min(len(buf), 0x4000) - 540),
                        540)
    if win.size < 2:
        return True
    ffs = np.nonzero(win[:-1] == 0xff)[0]
    if ffs.size == 0:
        return True
    return bool((win[ffs + 1] == 0).any())


def read_crw_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a Canon CRW (CIFF container) raw natively. The reference
    reaches CRW through libraw (``readraw_in_cfa``,
    image_formats_libraries.c:830); this parses the documented CIFF
    heap directly and decodes the 10-bit compressed sensor plane via
    native/canon_crw.cpp (64-sample Huffman blocks, column-parity
    predictors, block-DC carry), then merges the optional 2-bit
    low-order plane stored at file offset 26 (compressed data at
    540 + lowbits·H·W/4 — the fixed CRW layout). Geometry/margins come
    from CIFF SensorInfo (0x1031, same inclusive-border layout as the
    CR2 MakerNote tag 0xe0), the decoder-table number from 0x1835.
    Pattern: RGGB from the per-vendor table (conversion.c:55). Only
    decoder table 0 is supported (see canon_crw.cpp TABLE PROVENANCE).
    """
    import ctypes

    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 26 or buf[:2] != b"II" or buf[6:14] != b"HEAPCCDR":
        raise ValueError(f"{path}: not a Canon CRW (CIFF) file")
    (hlen,) = struct.unpack_from("<I", buf, 2)
    tags: dict = {}
    _ciff_tags(buf, hlen, len(buf) - hlen, tags)

    si = tags.get(0x1031)
    if not isinstance(si, tuple):
        raise ValueError(f"{path}: CIFF heap has no SensorInfo (0x1031)")
    aoff, ln = si
    sensor = np.frombuffer(buf, "<u2", min(ln // 2, 17), aoff)
    if sensor.size < 3:
        raise ValueError(f"{path}: truncated CIFF SensorInfo")
    raw_w, raw_h = int(sensor[1]), int(sensor[2])
    table = 0
    dt = tags.get(0x1835)
    if isinstance(dt, tuple):
        table = int(struct.unpack_from("<I", buf, dt[0])[0])

    lib = _load_crw()
    if lib is None:
        raise ValueError(f"{path}: CRW decode needs the native decoder "
                         f"(no C++ compiler available)")
    lowbits = 1 if _crw_has_lowbits(buf) else 0
    data_off = 540 + lowbits * raw_h * raw_w // 4
    data = buf[data_off:]
    out = np.empty(raw_h * raw_w, np.uint16)
    rc = lib.crw_decompress(
        data, len(data), raw_h, raw_w, table,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc == 2:
        raise ValueError(
            f"{path}: CRW decoder table {table} is not supported "
            f"(only table 0; see native/canon_crw.cpp)")
    if rc != 0:
        raise ValueError(f"{path}: corrupt CRW compressed stream "
                         f"(rc={rc})")
    plane = out.astype(np.uint16)
    if lowbits:
        nlow = raw_h * raw_w // 4
        lb = np.frombuffer(buf, np.uint8, nlow, 26)
        low = np.empty(raw_h * raw_w, np.uint16)
        for r in range(4):
            low[r::4] = (lb >> (2 * r)) & 3
        plane = (plane << 2) + low
        if raw_w == 2672:
            # documented width-2672 sensor quirk
            plane = np.where(plane < 512, plane + 2, plane)
    cfa = plane.reshape(raw_h, raw_w)
    if sensor.size >= 9:
        left, top = int(sensor[5]), int(sensor[6])
        right, bottom = int(sensor[7]), int(sensor[8])
        if 0 <= left < right < raw_w and 0 <= top < bottom < raw_h:
            cfa = cfa[top: bottom + 1, left: right + 1]
    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return np.ascontiguousarray(cfa), RAW_EXTENSIONS["crw"]


def read_raf_cfa(path: str) -> Tuple[np.ndarray, str]:
    """Decode a Fuji RAF raw for conventional (unrotated Bayer)
    sensors. The reference reaches RAF through libraw and itself flags
    the format "Not really supported, specially XTRANS"
    (conversion.c:57); matching that stance, Super-CCD 45°-rotated
    layouts and X-Trans sensors raise a clear error.

    Container (documented dcraw ``parse_fuji`` + identify): all
    big-endian; u32 CFA-header offset at byte 92, u32 CFA-data offset
    at byte 100. The CFA header is a u32 record count then
    (tag u16, len u16, body) records: tag 0x100 = raw height/width
    u16s; tag 0x130 = layout byte (bit 7 = rotated) and a byte whose
    bit 3 clear marks Super CCD; tag 0x131 present = X-Trans. Sample
    stream: 16-bit big-endian words. Pattern: GBRG from the
    per-vendor table (conversion.c:57).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"FUJIFILM":
        raise ValueError(f"{path}: not a Fuji RAF file")
    (cfa_hdr_off,) = struct.unpack(">I", buf[92:96])
    (data_off,) = struct.unpack(">I", buf[100:104])
    (entries,) = struct.unpack(">I", buf[cfa_hdr_off: cfa_hdr_off + 4])
    if entries > 255:
        raise ValueError(f"{path}: corrupt RAF CFA header")
    pos = cfa_hdr_off + 4
    raw_h = raw_w = None
    layout = 0
    super_ccd = False
    xtrans = False
    for _ in range(entries):
        tag, ln = struct.unpack(">HH", buf[pos: pos + 4])
        body = pos + 4
        if tag == 0x100:
            raw_h, raw_w = struct.unpack(">HH", buf[body: body + 4])
        elif tag == 0x130:
            layout = buf[body] >> 7
            super_ccd = not (buf[body + 1] & 8)
        elif tag == 0x131:
            xtrans = True
        pos = body + ln
    if raw_h is None:
        raise ValueError(f"{path}: RAF CFA header has no geometry tag")
    if layout or super_ccd or xtrans:
        raise ValueError(
            f"{path}: Fuji Super-CCD/X-Trans layouts are not supported, "
            f"like the reference (conversion.c:57)")
    cfa = np.frombuffer(buf, ">u2", raw_h * raw_w,
                        data_off).astype(np.uint16).reshape(raw_h, raw_w)
    from siriltpu_torch.io.conversion import RAW_EXTENSIONS
    return np.ascontiguousarray(cfa), RAW_EXTENSIONS["raf"]


def _rawpy_cfa(path: str) -> Tuple[np.ndarray, str]:
    """readraw_in_cfa semantics through rawpy/libraw: visible-area crop,
    pattern from the filter descriptor."""
    import rawpy
    with rawpy.imread(path) as raw:
        desc = raw.color_desc.decode("ascii")
        pat_idx = raw.raw_pattern  # (2,2) indices into desc
        if pat_idx.shape != (2, 2):
            raise ValueError("non-Bayer sensor (X-Trans?) not supported, "
                             "like the reference")
        pattern = "".join(desc[pat_idx[r, c]]
                          for r in range(2) for c in range(2))
        sizes = raw.sizes
        top, left = sizes.top_margin, sizes.left_margin
        h, w = sizes.iheight, sizes.iwidth
        cfa = np.ascontiguousarray(
            raw.raw_image[top: top + h, left: left + w]).astype(np.uint16)
    return cfa, pattern


def read_raw_cfa(path: str) -> Frame:
    """Load a camera raw as a mono CFA Frame (readraw_in_cfa +
    open_raw_files's vertical flip, image_formats_libraries.c:830,989).
    The Bayer pattern is stored in ``meta['bayer_pattern']``."""
    try:
        import rawpy  # noqa: F401
        cfa, pattern = _rawpy_cfa(path)
    except ImportError:
        low = path.lower()
        ext = low.rsplit(".", 1)[-1] if "." in low else ""
        if ext == "dng":
            cfa, pattern = read_dng_cfa(path)
        elif ext == "cr2":
            cfa, pattern = read_cr2_cfa(path)
        elif ext in ("arw", "sr2"):
            try:
                cfa, pattern = read_tiffraw_cfa(path, "arw")
            except ValueError:
                cfa, pattern = read_arw2_cfa(path)
        elif ext in ("nef", "nrw"):
            try:
                cfa, pattern = read_tiffraw_cfa(path, ext)
            except ValueError:
                cfa, pattern = read_nef_cfa(path)
        elif ext == "pef":
            try:
                cfa, pattern = read_tiffraw_cfa(path, ext)
            except ValueError:
                cfa, pattern = read_pef_cfa(path)
        elif ext == "orf":
            try:
                cfa, pattern = read_tiffraw_cfa(path, ext)
            except ValueError:
                cfa, pattern = read_orf_cfa(path)
        elif ext == "rw2":
            cfa, pattern = read_rw2_cfa(path)
        elif ext == "mrw":
            cfa, pattern = read_mrw_cfa(path)
        elif ext == "raf":
            cfa, pattern = read_raf_cfa(path)
        elif ext == "crw":
            cfa, pattern = read_crw_cfa(path)
        elif ext in ("srw", "erf", "mef", "raw", "3fr", "kdc", "dcr",
                     "mos"):
            cfa, pattern = read_tiffraw_cfa(path, ext)
        else:
            raise ValueError(
                f"{os.path.basename(path)}: decoding this raw format "
                f"requires rawpy/libraw (absent); built-in decoders "
                f"cover DNG (uncompressed or lossless-JPEG), CR2, CRW, "
                f"NEF (compressed or uncompressed), Sony ARW2, PEF, "
                f"ORF, RW2, MRW, Bayer RAF, and uncompressed TIFF-strip "
                f"raws")
    frame = Frame(cfa[::-1].copy())  # mirrorx: top-down -> bottom-up
    frame.meta["bayer_pattern"] = pattern
    return frame


def read_raw(path: str, *, device, cfa: bool = False, method: str = "vng",
             settings=None) -> Frame:
    """Load a camera raw; ``cfa=False`` also demosaics (the ``readraw``
    counterpart: decode + debayer with the configured method,
    conversion.c:736-781 semantics: flip to top-down, debayer, flip back).

    When ``settings`` (a :class:`siriltpu_torch.core.config.Settings`) is
    given, the demosaiced path applies the reference's libraw
    postprocess knobs around the debayer (WB multipliers / brightness /
    gamma, ``readraw`` image_formats_libraries.c:686-720 — see
    :mod:`siriltpu_torch.io.rawproc`) and the interpolation follows
    ``raw_user_qual`` instead of ``method``. With the default knobs
    every postprocess stage is the identity, matching the reference's
    defaults (conversion.c:233-245). Decoders that recover camera
    neutral values may set ``meta['cam_mul']`` / ``meta['black']`` /
    ``meta['maximum']``; absent metadata means daylight multipliers of
    1 and a 0 black level (documented divergence, PARITY.md).

    A VNG or AHD debayer of 2^20 pixels or more runs on ``device``; None
    refuses it (``ops.demosaic.debayer_buffer``)."""
    frame = read_raw_cfa(path)
    if cfa:
        return frame
    from siriltpu_torch.ops.demosaic import debayer_buffer
    topdown = frame.data[0][::-1]
    pattern = frame.meta["bayer_pattern"]
    lut = None
    if settings is not None:
        from siriltpu_torch.io.rawproc import USER_QUAL_METHODS, postprocess_cfa
        topdown, lut = postprocess_cfa(
            topdown, pattern, settings,
            cam_mul=frame.meta.get("cam_mul"),
            maximum=int(frame.meta.get("maximum", 65535)),
            black=int(frame.meta.get("black", 0)))
        method = USER_QUAL_METHODS.get(settings.raw_user_qual, "ahd")
    rgb = debayer_buffer(topdown, pattern, method, device=device)
    if lut is not None:
        rgb = lut[rgb]
    out = Frame(np.ascontiguousarray(rgb[:, ::-1]))
    out.meta.update(frame.meta)
    return out


__all__ = ["read_raw", "read_raw_cfa", "read_dng_cfa", "read_arw2_cfa",
           "decode_arw2", "sony_tone_curve"]
