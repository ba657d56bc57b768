"""ctypes bindings for the libav film codec bridge (native/film_codec.cpp).

``FilmDecoder`` is the ffms2 ``film_open_file``/``film_read_frame``
replacement (src/io/films.c:66,245): random access to any libavformat-
demuxable, libavcodec-decodable film (H.264/H.265 MP4/MOV, VP8/VP9
WEBM, MPEG, raw/MJPEG AVI, ...), producing gray or RGB frames.

``FilmEncoder`` is the ``mp4_create``/``mp4_add_frame`` replacement
(src/io/mp4_output.c:403,495): H.264 MP4 and VP9 WEBM export with the
reference's encoder parameters.

Both raise RuntimeError with the native error string on failure and
are unavailable (``available() == False``) when the system has no
libavformat/libavcodec.

Port of ``siriltpu.io.film_codec``: copied; the bridge is the port's build
of the same ``film_codec.cpp`` (``utils.native.load_film_native``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from siriltpu_torch.utils.native import load_film_native

_ERRLEN = 512


def _bind(lib) -> None:
    if getattr(lib, "_fcodec_bound", False):
        return
    lib.fcodec_open.restype = ctypes.c_void_p
    lib.fcodec_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.fcodec_read.restype = ctypes.c_int
    lib.fcodec_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int]
    lib.fcodec_close.restype = None
    lib.fcodec_close.argtypes = [ctypes.c_void_p]
    lib.fcodec_enc_open.restype = ctypes.c_void_p
    lib.fcodec_enc_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.fcodec_enc_add.restype = ctypes.c_int
    lib.fcodec_enc_add.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.fcodec_enc_close.restype = ctypes.c_int
    lib.fcodec_enc_close.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib._fcodec_bound = True


def available() -> bool:
    lib = load_film_native()
    if lib is None:
        return False
    _bind(lib)
    return True


class FilmDecoder:
    """Random-access film decoder. Frames come out as top-down packed
    numpy arrays: (H, W) for gray, (H, W, 3) for RGB; dtype uint8 for
    8-bit sources, uint16 for deeper ones (an upgrade over films.c:173
    which rejects 16-bit films)."""

    def __init__(self, path: str):
        lib = load_film_native()
        if lib is None:
            raise RuntimeError("film codec bridge unavailable "
                               "(libavformat/libavcodec not installed)")
        _bind(lib)
        self._lib = lib
        w = ctypes.c_int()
        h = ctypes.c_int()
        nl = ctypes.c_int()
        nf = ctypes.c_int()
        fps = ctypes.c_double()
        depth = ctypes.c_int()
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = lib.fcodec_open(path.encode(), ctypes.byref(w),
                                  ctypes.byref(h), ctypes.byref(nl),
                                  ctypes.byref(nf), ctypes.byref(fps),
                                  ctypes.byref(depth), err, _ERRLEN)
        if not self._h:
            raise RuntimeError(
                f"cannot open film {path}: {err.value.decode()}")
        self.path = path
        self.width = w.value
        self.height = h.value
        self.nb_layers = nl.value
        self.nb_frames = nf.value
        self.fps = fps.value
        self.depth = depth.value  # bytes per sample

    def read(self, index: int) -> np.ndarray:
        dtype = np.uint16 if self.depth == 2 else np.uint8
        shape = ((self.height, self.width) if self.nb_layers == 1
                 else (self.height, self.width, 3))
        out = np.empty(shape, dtype=dtype)
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = self._lib.fcodec_read(
            self._h, int(index),
            out.ctypes.data_as(ctypes.c_void_p), err, _ERRLEN)
        if rc != 0:
            raise RuntimeError(f"film frame {index} decode failed: "
                               f"{err.value.decode()}")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fcodec_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class FilmEncoder:
    """MP4 (H.264) / WEBM (VP9) sequence encoder with the reference's
    settings: yuv420p, gop 12, bitrate (quality+1)*w*h/2
    (mp4_output.c:441,120-121). Frames are packed top-down uint8 gray
    (H, W) or RGB (H, W, 3) at src size, resized to dst on the fly."""

    def __init__(self, path: str, dst_w: int, dst_h: int, fps: float,
                 nb_layers: int, quality: int = 3,
                 src_w: Optional[int] = None, src_h: Optional[int] = None):
        lib = load_film_native()
        if lib is None:
            raise RuntimeError("film codec bridge unavailable "
                               "(libavformat/libavcodec not installed)")
        _bind(lib)
        self._lib = lib
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = lib.fcodec_enc_open(
            path.encode(), int(dst_w), int(dst_h), float(fps),
            int(nb_layers), int(quality), int(src_w or dst_w),
            int(src_h or dst_h), err, _ERRLEN)
        if not self._h:
            raise RuntimeError(
                f"cannot create film {path}: {err.value.decode()}")
        self.path = path
        self.nb_layers = 1 if nb_layers == 1 else 3
        self.src_w = int(src_w or dst_w)
        self.src_h = int(src_h or dst_h)

    def add_frame(self, img: np.ndarray) -> None:
        """img: top-down uint8, (H, W) gray or (H, W, 3) RGB."""
        expect = ((self.src_h, self.src_w) if self.nb_layers == 1
                  else (self.src_h, self.src_w, 3))
        if img.dtype != np.uint8 or img.shape != expect:
            raise ValueError(
                f"expected uint8 array of shape {expect}, got "
                f"{img.dtype} {img.shape}")
        buf = np.ascontiguousarray(img)
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = self._lib.fcodec_enc_add(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), err, _ERRLEN)
        if rc != 0:
            raise RuntimeError(f"film encode failed: {err.value.decode()}")

    def close(self) -> None:
        if self._h:
            err = ctypes.create_string_buffer(_ERRLEN)
            rc = self._lib.fcodec_enc_close(self._h, err, _ERRLEN)
            self._h = None
            if rc != 0:
                raise RuntimeError(
                    f"film finalize failed: {err.value.decode()}")

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


__all__ = ["available", "FilmDecoder", "FilmEncoder"]
