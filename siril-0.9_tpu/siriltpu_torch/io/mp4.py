"""MP4 (ISO BMFF) movie export without ffmpeg.

Reference scope: src/io/mp4_output.c (mp4_create :403, mp4_add_frame
:495) wraps libavformat/libavcodec to encode H.264/VP9. This module
replaces that capability with a dependency-free muxer: Motion-JPEG
samples in a standard MP4 container (VisualSampleEntry ``mp4v`` with an
``esds`` whose objectTypeIndication is 0x6C = ISO/IEC 10918-1 JPEG —
the same mapping ffmpeg's mp4 muxer uses for MJPEG). Every mainstream
player (ffmpeg, VLC, mpv, QuickTime) decodes it.

Layout: ``ftyp`` + ``mdat`` (concatenated JPEG frames) + trailing
``moov`` with a single video track; every sample is a sync sample and
chunk == sample, so the tables are minimal (stts/stsc/stsz/stco).

Port of ``siriltpu.io.mp4``: copied byte for byte but for this note (the
handler name it writes is the reference's, so the files are equal).
"""

from __future__ import annotations

import struct


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full_box(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags) + payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with the canonical 4-byte expandable length."""
    n = len(payload)
    size = bytes([0x80 | ((n >> 21) & 0x7F), 0x80 | ((n >> 14) & 0x7F),
                  0x80 | ((n >> 7) & 0x7F), n & 0x7F])
    return bytes([tag]) + size + payload


def _esds(avg_size: int, fps: float) -> bytes:
    bitrate = max(1, int(avg_size * 8 * fps))
    dec_conf = _descriptor(0x04, struct.pack(
        ">BBBHII",
        0x6C,            # objectTypeIndication: ISO/IEC 10918-1 (JPEG)
        (0x04 << 2) | 1, # streamType visual, upStream 0, reserved 1
        0, 0,            # bufferSizeDB (24 bits, split B+H)
        bitrate, bitrate))
    sl_conf = _descriptor(0x06, b"\x02")
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + dec_conf + sl_conf)
    return _full_box(b"esds", 0, 0, es)


class Mp4Writer:
    """Minimal single-video-track MP4 muxer; frames are JPEG bytes."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 25.0):
        self.path = path
        self.width = width
        self.height = height
        self.fps = fps if fps > 0 else 25.0
        self._sizes = []
        self._offsets = []
        self._f = open(path, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512)
                           + b"isomiso2mp41"))
        self._mdat_start = self._f.tell()
        self._f.write(struct.pack(">I", 8) + b"mdat")  # size patched later

    def add_frame(self, jpeg: bytes) -> None:
        off = self._f.tell()
        if off + len(jpeg) > 0xFFFFFFFF:
            # stco/mdat use 32-bit offsets/sizes in this minimal muxer
            raise ValueError("MP4 output would exceed 4 GB; export in "
                             "chunks or use the SER/AVI containers")
        self._offsets.append(off)
        self._sizes.append(len(jpeg))
        self._f.write(jpeg)

    # ---- moov assembly -------------------------------------------------
    def _stbl(self, timescale: int, delta: int) -> bytes:
        n = len(self._sizes)
        avg = (sum(self._sizes) // n) if n else 0
        entry = struct.pack(
            ">6xH16xHHIIIH32sHh",
            1,                       # data_reference_index
            self.width, self.height,
            0x00480000, 0x00480000,  # 72 dpi
            0, 1,                    # reserved, frame_count
            b"\x05mjpeg",            # compressorname (counted string)
            24, -1)                  # depth, pre_defined
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1)
                         + _box(b"mp4v", entry + _esds(avg, self.fps)))
        stts = _full_box(b"stts", 0, 0,
                         struct.pack(">III", 1, n, delta))
        stsc = _full_box(b"stsc", 0, 0,
                         struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full_box(b"stsz", 0, 0,
                         struct.pack(">II", 0, n)
                         + b"".join(struct.pack(">I", s)
                                    for s in self._sizes))
        stco = _full_box(b"stco", 0, 0,
                         struct.pack(">I", n)
                         + b"".join(struct.pack(">I", o)
                                    for o in self._offsets))
        return _box(b"stbl", stsd + stts + stsc + stsz + stco)

    def close(self) -> None:
        if self._f is None:
            return
        n = len(self._sizes)
        timescale = 1000 * max(1, round(self.fps))
        delta = round(timescale / self.fps)
        duration = n * delta

        # patch mdat size
        end = self._f.tell()
        self._f.seek(self._mdat_start)
        self._f.write(struct.pack(">I", end - self._mdat_start))
        self._f.seek(end)

        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0,
                         b"\x00" * 4 + b"vide" + b"\x00" * 12
                         + b"siriltpu video\x00")
        vmhd = _full_box(b"vmhd", 0, 1, b"\x00" * 8)
        dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1)
                         + _full_box(b"url ", 0, 1, b""))
        minf = _box(b"minf", vmhd + _box(b"dinf", dref)
                    + self._stbl(timescale, delta))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                             0x40000000)
        tkhd = _full_box(b"tkhd", 0, 3,
                         struct.pack(">III4xI8xHHHH", 0, 0, 1, duration,
                                     0, 0, 0, 0)
                         + matrix
                         + struct.pack(">II", self.width << 16,
                                       self.height << 16))
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full_box(b"mvhd", 0, 0,
                         struct.pack(">IIIIIH2x8x", 0, 0, timescale,
                                     duration, 0x00010000, 0x0100)
                         + matrix
                         + b"\x00" * 24
                         + struct.pack(">I", 2))   # next_track_ID
        self._f.write(_box(b"moov", mvhd + trak))
        self._f.close()
        self._f = None


__all__ = ["Mp4Writer"]
