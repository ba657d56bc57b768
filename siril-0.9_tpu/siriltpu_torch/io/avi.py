"""AVI (DIB) export through the native C++ writer.

Reference: src/io/avi_pipp/ (PIPP-derived C++ RIFF writer, ~1.4k LoC).
The TPU framework keeps the writer native too (native/avi_writer.cpp,
built on demand with g++, loaded via ctypes); a pure-Python fallback
emits the identical container when no compiler is available.

Port of ``siriltpu.io.avi``: copied. The native writer is the port's build
of the same source (``utils.native``); Pillow is imported only for MJPEG.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from siriltpu_torch.core.frame import Frame

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    from siriltpu_torch.utils.native import load_native
    lib = load_native()
    if lib is None:
        return None
    lib.avi_create.restype = ctypes.c_void_p
    lib.avi_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_double,
                               ctypes.c_int]
    lib.avi_write_frame.restype = ctypes.c_int
    lib.avi_write_frame.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long]
    lib.avi_close.restype = ctypes.c_int
    lib.avi_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _frame_to_dib(frame: Frame, lo: int = 0, hi: int = 65535) -> bytes:
    """uint16 bottom-up Frame -> BGR24 bottom-up DIB rows (4-aligned),
    with the export display scaling (fits_to_uint8, sequence.c:1148-1170)."""
    h, w = frame.ry, frame.rx
    pente = 255.0 / max(hi - lo, 1)
    x = np.clip((frame.data.astype(np.float64) - lo) * pente + 0.5, 0, 255)
    img8 = x.astype(np.uint8)
    if frame.nlayers == 1:
        rgb = np.repeat(img8, 3, axis=0)
    else:
        rgb = img8
    bgr = rgb[::-1].transpose(1, 2, 0)  # (h, w, 3) BGR, rows bottom-up ✓
    row_bytes = (w * 3 + 3) & ~3
    if row_bytes != w * 3:
        padded = np.zeros((h, row_bytes), dtype=np.uint8)
        padded[:, : w * 3] = bgr.reshape(h, -1)
        return padded.tobytes()
    return bgr.tobytes()


def _frame_to_jpeg(frame: Frame, quality: int, lo: int = 0,
                   hi: int = 65535) -> bytes:
    """uint16 bottom-up Frame -> JPEG bytes (top-down, display-scaled)."""
    import io as _io

    from PIL import Image

    pente = 255.0 / max(hi - lo, 1)
    x = np.clip((frame.data.astype(np.float64) - lo) * pente + 0.5, 0, 255)
    img8 = x.astype(np.uint8)
    arr = (img8[0] if frame.nlayers == 1
           else img8.transpose(1, 2, 0))[::-1]  # top-down for JPEG
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class AviWriter:
    """AVI writer: uncompressed DIB (native C++ when a compiler exists,
    Python fallback) or MJPEG (PIL-encoded JPEG chunks — the compressed
    export path in an image with no ffmpeg)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 25.0, codec: str = "dib",
                 jpeg_quality: int = 90):
        if codec not in ("dib", "mjpeg"):
            raise ValueError(f"unknown AVI codec {codec}")
        self.path = path
        self.width = width
        self.height = height
        self.fps = fps if fps > 0 else 25.0
        self.codec = codec
        self.jpeg_quality = jpeg_quality
        self.nframes = 0
        self._handle = None
        self._py_frames = None
        if codec == "dib":
            lib = _load_native()
            if lib is not None:
                self._handle = lib.avi_create(path.encode(), width, height,
                                              self.fps, 1)
        if self._handle is None:
            self._py_frames = []

    @property
    def native(self) -> bool:
        return self._handle is not None

    def write_frame(self, frame: Frame, lo: int = 0, hi: int = 65535) -> None:
        if frame.rx != self.width or frame.ry != self.height:
            raise ValueError("AVI frame size mismatch")
        if self.codec == "mjpeg":
            self._py_frames.append(
                _frame_to_jpeg(frame, self.jpeg_quality, lo, hi))
            self.nframes += 1
            return
        payload = _frame_to_dib(frame, lo, hi)
        if self._handle is not None:
            rc = _load_native().avi_write_frame(self._handle, payload,
                                                len(payload))
            if rc != 0:
                raise IOError(f"native AVI write failed ({rc})")
        else:
            self._py_frames.append(payload)
        self.nframes += 1

    def close(self) -> None:
        if self._handle is not None:
            _load_native().avi_close(self._handle)
            self._handle = None
        elif self._py_frames is not None:
            self._write_python()
            self._py_frames = None

    def _write_python(self) -> None:
        """Pure-Python RIFF writer: fixed-size 00db DIB chunks or
        variable-size 00dc MJPEG chunks, with an idx1 index."""
        w, h = self.width, self.height
        n = len(self._py_frames)
        mjpeg = self.codec == "mjpeg"
        chunk_id = b"00dc" if mjpeg else b"00db"
        handler = b"MJPG" if mjpeg else b"DIB "
        bufsize = max((len(p) for p in self._py_frames), default=0)
        with open(self.path, "wb") as f:
            def tag(t): f.write(t)
            def u32(v): f.write(struct.pack("<I", v))
            def u16(v): f.write(struct.pack("<H", v))
            tag(b"RIFF"); riff_pos = f.tell(); u32(0); tag(b"AVI ")
            tag(b"LIST"); u32(4 + 8 + 56 + 8 + 4 + 8 + 56 + 8 + 40); tag(b"hdrl")
            tag(b"avih"); u32(56)
            u32(int(1000000 / self.fps)); u32(int(bufsize * self.fps))
            u32(0); u32(0x10); u32(n); u32(0); u32(1); u32(bufsize)
            u32(w); u32(h); u32(0); u32(0); u32(0); u32(0)
            tag(b"LIST"); u32(4 + 8 + 56 + 8 + 40); tag(b"strl")
            tag(b"strh"); u32(56)
            tag(b"vids"); tag(handler); u32(0); u16(0); u16(0); u32(0)
            u32(1000); u32(int(self.fps * 1000)); u32(0); u32(n)
            u32(bufsize); u32(0xFFFFFFFF); u32(0)
            u16(0); u16(0); u16(w); u16(h)
            tag(b"strf"); u32(40)
            u32(40); u32(w); u32(h); u16(1); u16(24)
            f.write(b"MJPG" if mjpeg else struct.pack("<I", 0))
            u32(w * h * 3); u32(2835); u32(2835); u32(0); u32(0)
            tag(b"LIST"); movi_size_pos = f.tell(); u32(0); tag(b"movi")
            movi_start = f.tell()
            index = []
            for payload in self._py_frames:
                index.append((f.tell() - movi_start + 4, len(payload)))
                tag(chunk_id); u32(len(payload)); f.write(payload)
                if len(payload) & 1:
                    f.write(b"\x00")
            movi_end = f.tell()
            tag(b"idx1"); u32(n * 16)
            for off, sz in index:
                tag(chunk_id); u32(0x10); u32(off); u32(sz)
            end = f.tell()
            f.seek(riff_pos); u32(end - 8)
            f.seek(movi_size_pos); u32(movi_end - movi_size_pos - 4)


__all__ = ["AviWriter"]
