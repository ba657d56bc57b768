"""Host-side image format support beyond FITS/SER.

Port of ``siriltpu.io.formats``, copied without change: BMP, PNM and
PIC are native and equal byte for byte; TIFF, JPEG, PNG and
``load_any``'s fallbacks import Pillow or imageio only when called.

Reference: src/io/image_formats_internal.c (BMP/PPM/PGM/PNM/PIC) and
src/io/image_formats_libraries.c (TIFF/JPG/PNG/RAW via libtiff/libjpeg/
libpng/libraw). Here: BMP and PNM are written natively; TIFF/JPG/PNG go
through Pillow/imageio; DSLR RAW decoding is gated on rawpy availability
(not in this environment — the conversion subsystem reports it).

All writers take bottom-up Frames and emit top-down files.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from siriltpu_torch.core.frame import Frame
from siriltpu_torch.utils.rounding import np_round_to_byte


def _to_display8(frame: Frame) -> np.ndarray:
    """uint16 -> uint8 via the conv_to_BYTE scale (utils.c:84-91)."""
    x = frame.data.astype(np.float64)
    out = (x / 65535.0) * 255.0
    return out.astype(np.uint8)


def write_bmp24(path: str, r8: np.ndarray, g8: np.ndarray,
                b8: np.ndarray) -> None:
    """24-bit BMP serialization exactly as savebmp
    (image_formats_internal.c:116-210): planes are uint8 (H, W) in
    display (top-down) row order; rows are written last-to-first (BMP
    bottom-up), pixels as B,G,R. The reference pads rows from the
    string literal ``"0"`` — the first pad byte is 0x30 and any further
    bytes are an out-of-bounds read of that literal, so we write 0x30
    then zeros. Header quirk kept: the image-size field lands at info
    byte 24 (savebmp:165), not the standard biSizeImage offset 20."""
    h, w = r8.shape
    padsize = (4 - (w * 3) % 4) % 4
    datasize = w * h * 3 + padsize * h
    filesize = datasize + 54
    hdr = bytearray(14)
    hdr[0:2] = b"BM"
    struct.pack_into("<I", hdr, 2, filesize)
    struct.pack_into("<I", hdr, 10, 54)
    info = bytearray(40)
    info[0] = 40
    struct.pack_into("<i", info, 4, w)
    struct.pack_into("<i", info, 8, h)
    info[12] = 1
    info[14] = 24
    struct.pack_into("<I", info, 24, datasize)
    bgr = np.stack([b8, g8, r8], axis=-1)[::-1]   # (h, w, 3), bottom row first
    pad = b"0" + b"\x00" * (padsize - 1) if padsize else b""
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(bytes(info))
        for row in range(h):
            f.write(bgr[row].tobytes())
            f.write(pad)


def save_bmp(path: str, frame: Frame) -> None:
    """BMP writer (image_formats_internal.c savebmp). The reference
    serializes the GUI display buffers; here the display remap is the
    linear conv_to_BYTE scale of the frame data."""
    img8 = _to_display8(frame)[:, ::-1, :]    # top-down display order
    if img8.shape[0] == 1:
        r8 = g8 = b8 = img8[0]
    else:
        r8, g8, b8 = img8
    write_bmp24(path, r8, g8, b8)


def load_bmp(path: str) -> Frame:
    """BMP reader (image_formats_internal.c readbmp:40-114). Reference
    quirks kept exactly: dimensions are 2-byte fields (header bytes
    18/22), the pixel-data offset is header BYTE 10 only (:66 — works
    for palette files because 1078 & 0xFF == 54), 8-bit files skip a
    1024-byte palette at that offset (:69-76), 32-bit files put alpha
    first when header byte 30 is nonzero (:97-99). No row flip: BMP's
    bottom-up rows are already Frame order."""
    with open(path, "rb") as f:
        header = f.read(54)
        if len(header) != 54:
            raise ValueError("readbmp: truncated header")
        lx = 256 * header[19] + header[18]
        ly = 256 * header[23] + header[22]
        nbplane = header[28] // 8
        if nbplane not in (1, 3, 4):
            raise ValueError("Siril cannot open this kind of BMP")
        padsize = (4 - (lx * nbplane) % 4) % 4
        nbdata = lx * ly * nbplane + ly * padsize
        f.seek(header[10])
        if nbplane == 1:
            if len(f.read(1024)) != 1024:
                raise ValueError("readbmp: failed to read the lut")
        buf = f.read(nbdata)
        if len(buf) != nbdata:
            raise ValueError("readbmp: truncated pixel data")
    arr = np.frombuffer(buf, np.uint8)
    if nbplane == 1:
        rows = arr.reshape(ly, lx + padsize)[:, :lx]
        data = rows[None]
    elif nbplane == 3:
        rows = arr.reshape(ly, lx * 3 + padsize)[:, :lx * 3]
        data = rows.reshape(ly, lx, 3)[..., ::-1].transpose(2, 0, 1)
    else:
        px = arr.reshape(ly, lx, 4)
        bgr = px[..., 1:4] if header[30] else px[..., 0:3]
        data = bgr[..., ::-1].transpose(2, 0, 1)
    return Frame(np.ascontiguousarray(data.astype(np.uint16)))


def save_pnm(path: str, frame: Frame) -> None:
    """PPM/PGM 16-bit writer (image_formats_internal.c saveppm:527-559,
    savepgm:561-586): magic, the ``# CREATOR : SIRIL`` comment line,
    dims, maxval 65535, then big-endian samples top-down."""
    data = frame.data[:, ::-1, :]  # top-down
    c, h, w = data.shape
    if not path.endswith((".ppm", ".pgm", ".pnm")):
        path += ".ppm" if c == 3 else ".pgm"
    with open(path, "wb") as f:
        if c == 3:
            f.write(f"P6\n# CREATOR : SIRIL\n{w} {h}\n65535\n".encode())
            f.write(data.transpose(1, 2, 0).astype(">u2").tobytes())
        else:
            f.write(f"P5\n# CREATOR : SIRIL\n{w} {h}\n65535\n".encode())
            f.write(data[0].astype(">u2").tobytes())


def load_pnm(path: str) -> Frame:
    """PNM reader (image_formats_internal.c import_pnm_to_fits:330-525).
    Reference strictness kept: binary P5/P6 only (ASCII and bitmap types
    rejected, :347), comment lines skipped before the dims AND before
    the maxval line (:363-366, :391-396), and maxval must be exactly
    255, 32767 or 65535 (:407-447 — anything else is an error).
    16-bit samples are big-endian; rows are file top-down."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P5", b"P6"):
            raise ValueError(
                "Wrong magic cookie in PNM file, ASCII types and b&w "
                "bitmaps are not supported")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        maxval = int(line)
        if maxval not in (255, 32767, 65535):
            raise ValueError(f"Not handled max value for PNM: {maxval}")
        dt = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
        nchan = 3 if magic == b"P6" else 1
        raw = np.fromfile(f, dtype=dt, count=w * h * nchan)
        if raw.size != w * h * nchan:
            raise ValueError("Error reading PPM image data")
        if nchan == 3:
            data = raw.reshape(h, w, 3).transpose(2, 0, 1)
        else:
            data = raw.reshape(1, h, w)
    return Frame(np.ascontiguousarray(
        data.astype(np.uint16)[:, ::-1, :]))


def save_tiff(path: str, frame: Frame, bits: int = 16) -> None:
    from PIL import Image
    data = frame.data[:, ::-1, :]
    if bits == 8:
        data = _to_display8(Frame(frame.data))[:, ::-1, :]
    arr = data[0] if data.shape[0] == 1 else data.transpose(1, 2, 0)
    if not path.endswith((".tif", ".tiff")):
        path += ".tif"
    if bits == 16 and arr.ndim == 3:
        # Pillow lacks native 16-bit RGB; fall back to imageio
        import imageio.v3 as iio
        iio.imwrite(path, arr.astype(np.uint16))
        return
    Image.fromarray(arr).save(path)


def load_tiff(path: str) -> Frame:
    import imageio.v3 as iio
    arr = np.asarray(iio.imread(path))
    return _from_topdown_array(arr)


def save_jpg(path: str, frame: Frame, quality: int = 100) -> None:
    from PIL import Image
    img8 = _to_display8(frame)[:, ::-1, :]
    arr = img8[0] if img8.shape[0] == 1 else img8.transpose(1, 2, 0)
    if not path.endswith((".jpg", ".jpeg")):
        path += ".jpg"
    Image.fromarray(arr).save(path, quality=quality)


def load_any(path: str) -> Optional[Frame]:
    """Best-effort loader for conversion inputs (PNG/JPG/TIFF/BMP/PNM)."""
    low = path.lower()
    if low.endswith((".pnm", ".ppm", ".pgm")):
        return load_pnm(path)
    if low.endswith(".bmp"):
        return load_bmp(path)
    if low.endswith(".pic"):
        return load_pic(path)
    if low.endswith((".fit", ".fits", ".fts")):
        from siriltpu_torch.io.fits import read_fits
        return read_fits(path)
    try:
        import imageio.v3 as iio
        arr = np.asarray(iio.imread(path))
    except Exception:
        return None
    return _from_topdown_array(arr)


def _from_topdown_array(arr: np.ndarray) -> Frame:
    if arr.ndim == 2:
        data = arr[None]
    else:
        data = arr[..., :3].transpose(2, 0, 1)
    if data.dtype == np.uint8:
        data = data.astype(np.uint16)  # BYTE values kept as-is (readfits rule)
    elif data.dtype != np.uint16:
        data = np.clip(data, 0, 65535).astype(np.uint16)
    return Frame(np.ascontiguousarray(data[:, ::-1, :]))


__all__ = ["save_bmp", "write_bmp24", "load_bmp", "save_pnm", "load_pnm",
           "save_tiff", "load_tiff", "save_jpg", "load_any"]


def load_pic(path: str) -> Frame:
    """IRIS PIC reader (image_formats_internal.c:653-780): 290-byte
    header, magic 0x31fc/0x0122, u16 LE geometry at offsets 68/70,
    nbplane at 92; plane-sequential uint16 data in file (bottom-up) order."""
    with open(path, "rb") as f:
        header = f.read(290)
        if len(header) != 290:
            raise ValueError("truncated PIC header")
        m0, m1 = struct.unpack_from("<HH", header, 0)
        if not (m0 == 0x31FC and m1 == 0x0122):
            raise ValueError("Wrong magic cookie in PIC file")
        w, h = struct.unpack_from("<HH", header, 68)
        nbplane = struct.unpack_from("<H", header, 92)[0]
        if nbplane not in (1, 3):
            raise ValueError(f"PIC with {nbplane} planes not supported")
        bins = struct.unpack_from("<6H", header, 80)
        hi, lo = struct.unpack_from("<HH", header, 118)
        raw = np.fromfile(f, dtype="<u2", count=w * h * nbplane)
    if raw.size != w * h * nbplane:
        raise ValueError("truncated PIC data")
    # binning from bin[4]/bin[5], display cutoffs at 118/120 (readpic)
    meta = {"binning_x": bins[4], "binning_y": bins[5], "hi": hi, "lo": lo}
    return Frame(raw.reshape(nbplane, h, w).astype(np.uint16), meta=meta)


def save_pic(path: str, frame: Frame) -> None:
    """PIC writer (for round-trip tests; the reference is read-only)."""
    header = bytearray(290)
    struct.pack_into("<HH", header, 0, 0x31FC, 0x0122)
    struct.pack_into("<HH", header, 68, frame.rx, frame.ry)
    struct.pack_into("<H", header, 92, frame.nlayers)
    with open(path, "wb") as f:
        f.write(bytes(header))
        frame.data.astype("<u2").tofile(f)
