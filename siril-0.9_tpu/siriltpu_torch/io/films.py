"""Film import: AVI, MP4, MOV, WEBM, MPEG, ...

Reference: src/io/films.c (FFMS2-based ``film_open_file`` :66,
``film_read_frame`` :245). Backend chain, fastest first:

- uncompressed DIB AVI files (what the reference's AVI exporter and our
  native writer produce) are demuxed natively with a small RIFF parser;
- MJPEG AVI files — the dominant planetary-capture container — are
  demuxed by the same RIFF parser and each frame's JPEG chunk is decoded
  with PIL, inserting the standard Huffman tables when the stream omits
  them (most MJPEG encoders rely on the decoder carrying T.81 Annex K);
- MJPEG MP4/MOV go through the built-in ISO-BMFF parser;
- everything else (H.264/H.265/VP8/VP9/MPEG...) decodes through the
  native libav bridge (native/film_codec.cpp + io/film_codec.py) — the
  full ffms2-class scope of the reference — when the system has
  libavformat/libavcodec;
- finally imageio, if one of its plugins can handle the file.

Port of ``siriltpu.io.films``, which is NumPy and struct already: copied,
with the imports pointed at the port. ``FILM_EXTENSIONS`` lives here, as in
the reference; ``io/conversion.py`` and ``io/sequence.py`` read it. A film
sequence reads a whole frame for every part it is asked for, as the
reference's does.
"""

from __future__ import annotations

import io as _io
import os
import struct
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame

FILM_EXTENSIONS = ("avi", "mpg", "mpeg", "mp4", "webm", "mov", "mkv")


# ---------------------------------------------------------------- MJPEG DHT
# MJPEG streams usually omit the DHT segment; decoders must supply the
# "typical" Huffman tables from ITU T.81 Annex K (tables K.3-K.6). Build
# the standard 4-table DHT segment once.

_DC_LUM_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUM_VALS = list(range(12))
_DC_CHR_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHR_VALS = list(range(12))
_AC_LUM_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUM_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_CHR_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHR_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _standard_dht() -> bytes:
    """One DHT marker segment carrying all four T.81 Annex K tables."""
    body = b""
    for cls_id, bits, vals in ((0x00, _DC_LUM_BITS, _DC_LUM_VALS),
                               (0x10, _AC_LUM_BITS, _AC_LUM_VALS),
                               (0x01, _DC_CHR_BITS, _DC_CHR_VALS),
                               (0x11, _AC_CHR_BITS, _AC_CHR_VALS)):
        body += bytes([cls_id]) + bytes(bits) + bytes(vals)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


_STANDARD_DHT = _standard_dht()


def ensure_jpeg_dht(data: bytes) -> bytes:
    """Insert the standard Huffman tables into a JPEG that has no DHT
    segment (the MJPEG convention). Returns the input unchanged if a DHT
    is already present or the stream isn't a baseline JPEG."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        return data
    pos = 2
    insert_at = -1
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return data  # corrupt marker stream; let the decoder complain
        marker = data[pos + 1]
        if marker == 0xC4:
            return data  # DHT present — nothing to do
        if marker == 0xDA:  # SOS: scan starts, no DHT was seen
            insert_at = pos
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2  # standalone markers
            continue
        (seglen,) = struct.unpack_from(">H", data, pos + 2)
        pos += 2 + seglen
    if insert_at < 0:
        return data
    return data[:insert_at] + _STANDARD_DHT + data[insert_at:]


def _decode_jpeg_chunk(data: bytes) -> np.ndarray:
    """JPEG chunk → top-down (H, W[, 3]) uint8 array via PIL."""
    from PIL import Image

    img = Image.open(_io.BytesIO(ensure_jpeg_dht(data)))
    if img.mode not in ("L", "RGB"):
        img = img.convert("RGB" if "A" in img.mode or len(img.getbands()) > 1
                          else "L")
    return np.asarray(img)


def _topdown_to_frame(arr: np.ndarray) -> Frame:
    """Top-down HW/HW3 uint8/16 → bottom-up (C, H, W) uint16 Frame,
    collapsing grey-encoded-as-RGB to one layer like the DIB path."""
    arr = arr[::-1]  # to bottom-up
    if arr.ndim == 2:
        return Frame(np.ascontiguousarray(arr.astype(np.uint16))[None])
    chw = arr.transpose(2, 0, 1).astype(np.uint16)
    if (chw[0] == chw[1]).all() and (chw[1] == chw[2]).all():
        return Frame(np.ascontiguousarray(chw[:1]))
    return Frame(np.ascontiguousarray(chw))


@dataclass
class FilmFile:
    path: str
    width: int = 0
    height: int = 0
    nb_frames: int = 0
    fps: float = 25.0
    _chunks: List[Tuple[int, int]] = field(default_factory=list)
    _dib_bpp: int = 24
    _backend: str = "dib"  # dib | mjpeg | codec | imageio
    _codec: object = None

    @classmethod
    def open(cls, path: str) -> "FilmFile":
        # struct/index errors from truncated or hostile files are just
        # "not a demuxable container" — normalize to the fallback path
        if path.lower().endswith(".avi"):
            try:
                return cls._open_avi(path)
            except (ValueError, KeyError, struct.error, IndexError,
                    EOFError):
                pass
        if path.lower().endswith((".mp4", ".mov", ".m4v")):
            try:
                return cls._open_mp4(path)
            except (ValueError, KeyError, struct.error, IndexError,
                    EOFError):
                pass
        # libav bridge: H.264/H.265/VP8/VP9/MPEG/... — the ffms2-class
        # decode scope of the reference (films.c:66) as a native module.
        # Indexing scans every packet, so the result is cached in a
        # sidecar (the ffms2 "<film>.idx" analog, films.c:85-121) and
        # the decoder itself opens lazily on the first frame read —
        # discovery scans (check_seq) stay cheap.
        from siriltpu_torch.io import film_codec
        if film_codec.available():
            meta = cls._read_index_cache(path)
            if meta is not None:
                f = cls(path=path, width=meta["width"],
                        height=meta["height"], nb_frames=meta["nb_frames"],
                        fps=meta["fps"])
                f._backend = "codec"
                return f
            try:
                dec = film_codec.FilmDecoder(path)
                f = cls(path=path, width=dec.width, height=dec.height,
                        nb_frames=dec.nb_frames, fps=dec.fps or 25.0)
                f._backend = "codec"
                f._codec = dec
                cls._write_index_cache(path, f)
                return f
            except RuntimeError:
                pass
        # fallback: imageio plugin (requires an ffmpeg backend for most)
        try:
            import imageio.v3 as iio
            props = iio.improps(path, index=0)
            meta = iio.immeta(path)
            n = meta.get("nframes") or meta.get("n_frames") or 0
            if not isinstance(n, int) or n <= 0:
                n = len(iio.imread(path, index=None))
            f = cls(path=path, width=props.shape[1], height=props.shape[0],
                    nb_frames=int(n), fps=float(meta.get("fps", 25.0)))
            f._backend = "imageio"
            return f
        except Exception as e:
            raise RuntimeError(
                f"Cannot open film {os.path.basename(path)}: no ffmpeg "
                f"backend available ({e})") from e

    @classmethod
    def _open_avi(cls, path: str) -> "FilmFile":
        """RIFF demuxer for uncompressed-DIB and MJPEG AVIs."""
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(4) != b"RIFF":
                raise ValueError("not a RIFF file")
            f.seek(8)
            if f.read(4) != b"AVI ":
                raise ValueError("not an AVI")
            width = height = 0
            fps = 25.0
            chunks: List[Tuple[int, int]] = []
            bpp = 24
            compression = 0  # BI_RGB

            # walk chunks
            def walk(end):
                nonlocal width, height, fps, bpp, compression
                while f.tell() + 8 <= end:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        break
                    tag = hdr[:4]
                    (sz,) = struct.unpack("<I", hdr[4:])
                    start = f.tell()
                    if tag == b"LIST":
                        f.read(4)  # list type
                        walk(start + sz)
                    elif tag == b"avih":
                        data = f.read(sz)
                        (uspf,) = struct.unpack_from("<I", data, 0)
                        if uspf:
                            fps = 1e6 / uspf
                        width, height = struct.unpack_from("<II", data, 32)
                    elif tag == b"strf":
                        data = f.read(sz)
                        if sz >= 40:  # BITMAPINFOHEADER
                            bpp = struct.unpack_from("<H", data, 14)[0]
                            compression = struct.unpack_from("<I", data, 16)[0]
                    elif tag in (b"00db", b"00dc"):
                        chunks.append((start, sz))
                        f.seek(sz, 1)
                    else:
                        f.seek(sz, 1)
                    if (f.tell() - start) % 2:
                        f.seek(1, 1)  # chunk padding
            walk(size)
            if not chunks or not width:
                raise ValueError("no video frames found")
        comp_tag = struct.pack("<I", compression)
        if compression == 0:
            backend = "dib"
        elif comp_tag in (b"MJPG", b"mjpg", b"dmb1", b"jpeg", b"JPEG"):
            backend = "mjpeg"
        else:
            raise ValueError(
                f"unsupported AVI codec {comp_tag!r} — only uncompressed "
                f"DIB and MJPEG are demuxed natively")
        film = cls(path=path, width=width, height=height,
                   nb_frames=len(chunks), fps=fps)
        film._chunks = chunks
        film._dib_bpp = bpp
        film._backend = backend
        return film

    @classmethod
    def _open_mp4(cls, path: str) -> "FilmFile":
        """ISO-BMFF (MP4/MOV) demuxer for Motion-JPEG video tracks —
        the counterpart of io/mp4.py's muxer, and reads real Siril/
        ffmpeg MJPEG-in-MP4 output too. H.264/H.265 tracks raise here
        and fall through to the libav codec bridge in ``open``
        (reference scope: src/io/films.c via ffms2)."""

        def boxes(buf, start, end):
            off = start
            while off + 8 <= end:
                size, = struct.unpack_from(">I", buf, off)
                tag = buf[off + 4 : off + 8]
                if size == 1:   # 64-bit size
                    size, = struct.unpack_from(">Q", buf, off + 8)
                    yield tag, off + 16, off + size
                else:
                    if size < 8:
                        return
                    yield tag, off + 8, off + size
                off += size

        size = os.path.getsize(path)
        with open(path, "rb") as f:
            # top-level scan for moov (read only headers + moov body)
            moov = None
            off = 0
            while off + 8 <= size:
                f.seek(off)
                hdr = f.read(16)
                if len(hdr) < 8:
                    break
                bsz, = struct.unpack_from(">I", hdr, 0)
                tag = hdr[4:8]
                body = off + 8
                if bsz == 1:
                    bsz, = struct.unpack_from(">Q", hdr, 8)
                    body = off + 16
                if bsz < 8:
                    break
                if tag == b"moov":
                    f.seek(body)
                    moov = f.read(off + bsz - body)
                    break
                off += bsz
        if moov is None:
            raise ValueError("no moov box")

        def find(buf, s, e, *tags):
            for tag, bs, be in boxes(buf, s, e):
                if tag == tags[0]:
                    if len(tags) == 1:
                        return bs, be
                    return find(buf, bs, be, *tags[1:])
            return None

        # locate the video trak
        video = None
        for tag, bs, be in boxes(moov, 0, len(moov)):
            if tag != b"trak":
                continue
            h = find(moov, bs, be, b"mdia", b"hdlr")
            if h and moov[h[0] + 8 : h[0] + 12] == b"vide":
                video = (bs, be)
                break
        if video is None:
            raise ValueError("no video track")
        bs, be = video
        mdhd = find(moov, bs, be, b"mdia", b"mdhd")
        timescale = struct.unpack_from(">I", moov, mdhd[0] + 12)[0]
        stbl = find(moov, bs, be, b"mdia", b"minf", b"stbl")
        tbl = {t: (s0, e0) for t, s0, e0 in boxes(moov, *stbl)}

        # codec gate
        s0, _ = tbl[b"stsd"]
        fourcc = moov[s0 + 8 + 4 : s0 + 8 + 8]
        if fourcc == b"mp4v":
            # esds objectTypeIndication must be JPEG (0x6C)
            entry = moov[s0 + 8 : tbl[b"stsd"][1]]
            z = entry.find(b"esds")
            oti = None
            if z >= 0:
                # ES(03) hdr -> DecoderConfig(04): OTI is the byte after
                # the tag 0x04 and its expandable length
                p = entry.find(b"\x04", z + 8)
                while p >= 0:
                    q = p + 1
                    while entry[q] & 0x80:
                        q += 1
                    oti = entry[q + 1]
                    break
            if oti != 0x6C:
                raise ValueError(
                    f"unsupported mp4v codec (OTI {oti}) — only MJPEG "
                    f"(ISO/IEC 10918-1) video is demuxed natively")
        elif fourcc not in (b"jpeg", b"mjpa", b"AVDJ"):
            raise ValueError(
                f"unsupported MP4 codec {fourcc!r} — only MJPEG video "
                f"is demuxed natively (H.264/H.265 need ffmpeg)")
        width, height = struct.unpack_from(">HH", moov, s0 + 8 + 32)

        # sample tables
        s0, _ = tbl[b"stsz"]
        fixed, n = struct.unpack_from(">II", moov, s0 + 4)
        sizes = ([fixed] * n if fixed else
                 list(struct.unpack_from(f">{n}I", moov, s0 + 12)))
        if b"stco" in tbl:
            s0, _ = tbl[b"stco"]
            nc, = struct.unpack_from(">I", moov, s0 + 4)
            coff = struct.unpack_from(f">{nc}I", moov, s0 + 8)
        else:
            s0, _ = tbl[b"co64"]
            nc, = struct.unpack_from(">I", moov, s0 + 4)
            coff = struct.unpack_from(f">{nc}Q", moov, s0 + 8)
        s0, _ = tbl[b"stsc"]
        ne, = struct.unpack_from(">I", moov, s0 + 4)
        stsc = [struct.unpack_from(">III", moov, s0 + 8 + 12 * k)
                for k in range(ne)]
        chunks = []
        si = 0
        for ci in range(nc):
            spc = 1
            for first, cnt, _sdi in stsc:
                if ci + 1 >= first:
                    spc = cnt
            o = coff[ci]
            for _ in range(spc):
                if si >= n:
                    break
                chunks.append((o, sizes[si]))
                o += sizes[si]
                si += 1
        # fps from stts
        fps = 25.0
        if b"stts" in tbl and timescale:
            s0, _ = tbl[b"stts"]
            ne, = struct.unpack_from(">I", moov, s0 + 4)
            if ne >= 1:
                _cnt, delta = struct.unpack_from(">II", moov, s0 + 8)
                if delta:
                    fps = timescale / delta
        if not chunks:
            raise ValueError("no samples")
        film = cls(path=path, width=int(width), height=int(height),
                   nb_frames=len(chunks), fps=float(fps))
        film._chunks = chunks
        film._backend = "mjpeg"
        return film

    @staticmethod
    def _index_cache_path(path: str) -> str:
        return path + ".idx.json"

    @classmethod
    def _read_index_cache(cls, path: str):
        """Load the film-index sidecar if it matches the current file
        (size + mtime), like ffms2's FFMS_ReadIndex (films.c:89)."""
        import json
        try:
            st = os.stat(path)
            with open(cls._index_cache_path(path)) as f:
                meta = json.load(f)
            if (meta.get("size") == st.st_size
                    and meta.get("mtime") == int(st.st_mtime)
                    and meta.get("nb_frames", 0) > 0):
                return meta
        except (OSError, ValueError):
            pass
        return None

    @classmethod
    def _write_index_cache(cls, path: str, film: "FilmFile") -> None:
        import json
        try:
            st = os.stat(path)
            with open(cls._index_cache_path(path), "w") as f:
                json.dump({"size": st.st_size, "mtime": int(st.st_mtime),
                           "width": film.width, "height": film.height,
                           "nb_frames": film.nb_frames,
                           "fps": film.fps}, f)
        except OSError:
            pass  # read-only dir: just skip the cache

    def read_frame(self, index: int) -> Frame:
        """film_read_frame: returns a bottom-up uint16 Frame."""
        if self._backend == "codec":
            if index < 0 or index >= self.nb_frames:
                raise IndexError(index)
            if self._codec is None:   # cache-hit open: decoder is lazy
                from siriltpu_torch.io.film_codec import FilmDecoder
                self._codec = FilmDecoder(self.path)
            # top-down gray/RGB (uint8, or uint16 for deep sources) →
            # bottom-up planar WORD with the reference's gray-in-RGB
            # collapse (films.c:269-300)
            return _topdown_to_frame(self._codec.read(index))
        if self._backend == "imageio":
            import imageio.v3 as iio
            arr = np.asarray(iio.imread(self.path, index=index))
            from siriltpu_torch.io.formats import _from_topdown_array
            return _from_topdown_array(arr)
        if index < 0 or index >= self.nb_frames:
            raise IndexError(index)
        offset, sz = self._chunks[index]
        if self._backend == "mjpeg":
            with open(self.path, "rb") as f:
                f.seek(offset)
                data = f.read(sz)
            return _topdown_to_frame(_decode_jpeg_chunk(data))
        w, h = self.width, self.height
        row_bytes = (w * 3 + 3) & ~3
        with open(self.path, "rb") as f:
            f.seek(offset)
            raw = np.frombuffer(f.read(row_bytes * h), dtype=np.uint8)
        rows = raw.reshape(h, row_bytes)[:, : w * 3].reshape(h, w, 3)
        # DIB rows are bottom-up BGR; our convention is bottom-up RGB
        rgb = rows[..., ::-1].transpose(2, 0, 1).astype(np.uint16)
        if (rgb[0] == rgb[1]).all() and (rgb[1] == rgb[2]).all():
            return Frame(np.ascontiguousarray(rgb[:1]))
        return Frame(np.ascontiguousarray(rgb))


def film_sequence(path: str):
    """Open a film as a Sequence (SEQ_AVI analog)."""
    from siriltpu_torch.core.frame import ImgParam
    from siriltpu_torch.io.sequence import Sequence

    film = FilmFile.open(path)
    base = os.path.basename(path).rsplit(".", 1)[0]

    class _FilmSequence(Sequence):
        def read_frame(self, index):
            frame = film.read_frame(index)
            self._ensure_geometry(frame)
            return frame

        def read_frame_part(self, index, layer, area):
            img = self.read_frame(index).data[layer][::-1]
            return np.ascontiguousarray(
                img[area.y : area.y + area.h, area.x : area.x + area.w])

    seq = _FilmSequence(seqname=base, seqtype="film", number=film.nb_frames,
                        selnum=film.nb_frames,
                        seq_dir=os.path.dirname(os.path.abspath(path)) or ".")
    seq.imgparam = [ImgParam(filenum=i) for i in range(film.nb_frames)]
    seq.rx, seq.ry = film.width, film.height
    return seq


__all__ = ["FilmFile", "film_sequence", "ensure_jpeg_dht", "FILM_EXTENSIONS"]
