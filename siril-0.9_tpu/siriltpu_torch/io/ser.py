"""SER v2/v3 video file reader/writer.

Port of ``siriltpu.io.ser``, which is NumPy already: copied without
change, but for two things. The reads that debayer a CFA file take the
``device`` that ``ops/demosaic.py`` runs VNG and AHD on for frames of
2^20 pixels or more (None refuses those). And a partial read of a mono
file whose area spans the full width reads its rows in one piece.

Reference: src/io/ser.c, src/io/ser.h.

Header is 178 bytes little-endian (SER_HEADER_LEN, ser.h:15):
FileID[14] LuID:i32 ColorID:i32 LittleEndian:i32 Width:i32 Height:i32
PixelDepth:i32 FrameCount:u32 Observer[40] Instrument[40] Telescope[40]
Date:i64 DateUTC:i64. A trailer of 8-byte timestamps (100 ns ticks) may
follow the frames.

Quirks reproduced:

- the ``LittleEndian`` header flag is used with INVERTED meaning by the
  first SER implementations and by Siril: 0 = little endian data,
  1 = big endian data (ser.h:32-42).
- frames are stored top-down; Siril flips to its bottom-up convention after
  reading (``ser_read_frame`` ends with ``fits_flip_top_to_bottom``,
  ser.c:767). We do the same.
- RGB/BGR (SER v3) store interleaved pixels; they are de-interleaved to
  channel-planar, with R/B swapped for BGR (ser.c:738-757).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from siriltpu_torch.core.frame import Frame, Rect

SER_HEADER_LEN = 178

# color_id enum (ser.h:17-29)
SER_MONO = 0
SER_BAYER_RGGB = 8
SER_BAYER_GRBG = 9
SER_BAYER_GBRG = 10
SER_BAYER_BGGR = 11
SER_BAYER_CYYM = 16
SER_BAYER_YCMY = 17
SER_BAYER_YMCY = 18
SER_BAYER_MYYC = 19
SER_RGB = 100
SER_BGR = 101

BAYER_IDS = (SER_BAYER_RGGB, SER_BAYER_GRBG, SER_BAYER_GBRG, SER_BAYER_BGGR)

_HEADER_FMT = "<14siiiiiiI40s40s40sqq"

def _planes_for_color(color_id: int) -> int:
    return 3 if color_id in (SER_RGB, SER_BGR) else 1


@dataclass
class SerHeader:
    file_id: str = "LUCAM-RECORDER"
    lu_id: int = 0
    color_id: int = SER_MONO
    little_endian: int = 0  # INVERTED quirk: 0 = LE data, 1 = BE data
    width: int = 0
    height: int = 0
    bit_pixel_depth: int = 16
    frame_count: int = 0
    observer: str = ""
    instrument: str = ""
    telescope: str = ""
    date: int = 0
    date_utc: int = 0

    @property
    def byte_pixel_depth(self) -> int:
        return 1 if self.bit_pixel_depth <= 8 else 2

    @property
    def number_of_planes(self) -> int:
        return _planes_for_color(self.color_id)

    @property
    def frame_nbytes(self) -> int:
        return self.width * self.height * self.number_of_planes * self.byte_pixel_depth

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT,
            self.file_id.encode("ascii")[:14].ljust(14, b"\x00"),
            self.lu_id, self.color_id, self.little_endian,
            self.width, self.height, self.bit_pixel_depth, self.frame_count,
            self.observer.encode("ascii")[:40].ljust(40, b"\x00"),
            self.instrument.encode("ascii")[:40].ljust(40, b"\x00"),
            self.telescope.encode("ascii")[:40].ljust(40, b"\x00"),
            self.date, self.date_utc,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "SerHeader":
        (fid, lu, cid, le, w, h, depth, count, obs, inst, tel, date,
         date_utc) = struct.unpack(_HEADER_FMT, raw[:SER_HEADER_LEN])
        return cls(
            file_id=fid.decode("ascii", "replace").rstrip("\x00 "),
            lu_id=lu, color_id=cid, little_endian=le, width=w, height=h,
            bit_pixel_depth=depth, frame_count=count,
            observer=obs.decode("ascii", "replace").rstrip("\x00 "),
            instrument=inst.decode("ascii", "replace").rstrip("\x00 "),
            telescope=tel.decode("ascii", "replace").rstrip("\x00 "),
            date=date, date_utc=date_utc,
        )


@dataclass
class SerFile:
    """An opened SER file (read or write). Mirrors ``struct ser_struct``."""

    path: str
    header: SerHeader
    timestamps: List[int] = field(default_factory=list)
    _writable: bool = False

    # ------------------------------------------------------------------ open

    @classmethod
    def open(cls, path: str) -> "SerFile":
        """Open an existing SER file (``ser_open_file``, ser.c:599-637),
        including header fixes for broken frame counts
        (``ser_fix_broken_file``, ser.c:268) and timestamp trailer parsing."""
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            header = SerHeader.unpack(f.read(SER_HEADER_LEN))
            if header.width <= 0 or header.height <= 0 or header.frame_count < 0:
                raise ValueError(f"bad SER header in {path}")
            fb = header.frame_nbytes
            max_frames = (size - SER_HEADER_LEN) // fb if fb else 0
            repaired = False
            if header.frame_count == 0:
                # the reference repairs ONLY the crashed-capture case
                # (header count 0, ser.c:337-344) and rewrites the header;
                # a nonzero count on a short file is kept as-is and later
                # frame reads fail, exactly like ser_read_frame's
                # short-read error (verified in test_c_goldens)
                header.frame_count = int(max_frames)
                repaired = header.frame_count > 0
            ts: List[int] = []
            ts_off = SER_HEADER_LEN + fb * header.frame_count
            if size >= ts_off + 8 * header.frame_count and header.frame_count > 0:
                f.seek(ts_off)
                raw = np.fromfile(f, dtype="<u8", count=header.frame_count)
                if raw.size == header.frame_count:
                    ts = [int(t) for t in raw]
        if repaired:
            with open(path, "r+b") as f:
                f.write(header.pack())   # "SER file has been fixed..."
        return cls(path=path, header=header, timestamps=ts)

    @classmethod
    def create(cls, path: str, width: int, height: int, *, color_id: int = SER_MONO,
               bit_pixel_depth: int = 16, copy_from: Optional["SerFile"] = None,
               overwrite: bool = True) -> "SerFile":
        """Create a new SER file (``ser_create_file``, ser.c:537-597)."""
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(path)
            os.unlink(path)
        # the reference stamps its own files "Made by Siril" (NUL-padded,
        # ser.c:576) rather than the capture-software default id
        header = SerHeader(file_id="Made by Siril",
                           width=width, height=height, color_id=color_id,
                           bit_pixel_depth=bit_pixel_depth, frame_count=0,
                           little_endian=0)
        if copy_from is not None:
            header.observer = copy_from.header.observer
            header.instrument = copy_from.header.instrument
            header.telescope = copy_from.header.telescope
            header.date = copy_from.header.date
            header.date_utc = copy_from.header.date_utc
        with open(path, "wb") as f:
            f.write(header.pack())
        return cls(path=path, header=header, _writable=True)

    @property
    def frame_count(self) -> int:
        return self.header.frame_count

    @property
    def fps(self) -> float:
        """Frame rate from timestamp span (ser.c ser_read_timestamp)."""
        if len(self.timestamps) >= 2:
            span = max(self.timestamps) - min(self.timestamps)
            if span > 0:
                return (len(self.timestamps) - 1) * 1e7 / span
        return 0.0

    # ------------------------------------------------------------------ read

    def _read_raw_frame(self, frame_no: int) -> np.ndarray:
        """Raw frame as uint16 (8-bit widened), interleaved, top-down rows."""
        h = self.header
        if frame_no < 0 or frame_no >= h.frame_count:
            raise IndexError(f"frame {frame_no} out of range 0..{h.frame_count-1}")
        offset = SER_HEADER_LEN + h.frame_nbytes * frame_no
        n = h.width * h.height * h.number_of_planes
        with open(self.path, "rb") as f:
            f.seek(offset)
            if h.byte_pixel_depth == 1:
                raw = np.fromfile(f, dtype=np.uint8, count=n).astype(np.uint16)
            else:
                # inverted endian convention (ser.h:32-42)
                dt = ">u2" if h.little_endian == 1 else "<u2"
                raw = np.fromfile(f, dtype=dt, count=n).astype(np.uint16)
        if raw.size != n:
            raise ValueError(f"truncated SER frame {frame_no}")
        return raw

    def read_frame(self, frame_no: int, *, debayer: bool = False,
                   bayer_pattern: Optional[str] = None,
                   bayer_method: str = "bilinear", device=None) -> Frame:
        """Read one frame as a bottom-up Frame (``ser_read_frame``, ser.c:649-769).

        Bayer SER files are returned mono unless ``debayer=True`` (the
        ``open_debayer`` setting in the reference, ser.c:727-730);
        ``device`` is where VNG and AHD debayer a large frame
        (``ops.demosaic.debayer_buffer``).
        """
        h = self.header
        raw = self._read_raw_frame(frame_no)
        color = h.color_id
        if not debayer and color not in (SER_RGB, SER_BGR):
            color = SER_MONO
        if color in (SER_RGB, SER_BGR):
            img = raw.reshape(h.height, h.width, 3).transpose(2, 0, 1)
            if color == SER_BGR:
                img = img[::-1]
            data = img
        elif color in BAYER_IDS:
            from siriltpu_torch.ops.demosaic import debayer_buffer, pattern_from_ser
            cfa = raw.reshape(h.height, h.width)
            pat = bayer_pattern or pattern_from_ser(color)
            data = debayer_buffer(cfa, pat, bayer_method,
                                  device=device)  # (3,H,W) top-down
        elif color == SER_MONO:
            data = raw.reshape(1, h.height, h.width)
        else:
            raise ValueError(f"SER Bayer pattern {color} not handled (CYYM family)")
        # flip to bottom-up (ser.c:767)
        frame = Frame(np.ascontiguousarray(data[:, ::-1, :]))
        if frame_no < len(self.timestamps):
            frame.meta["ser_timestamp"] = self.timestamps[frame_no]
        return frame

    def read_opened_partial(self, layer: int, frame_no: int, area: Rect, *,
                            debayer: bool = False,
                            bayer_pattern: Optional[str] = None,
                            bayer_method: str = "bilinear", device=None) -> np.ndarray:
        """Read one layer's region, rows TOP-DOWN like the reference's
        ``ser_read_opened_partial`` (ser.c:772-971), including the
        demosaic-window expansion logic for Bayer files (:820-913)."""
        h = self.header
        color = h.color_id
        if not debayer and color not in (SER_RGB, SER_BGR):
            color = SER_MONO

        if color == SER_MONO:
            # direct row reads of the region (top-down storage matches area y)
            offset = SER_HEADER_LEN + h.frame_nbytes * frame_no
            bpd = h.byte_pixel_depth
            # inverted endian convention (ser.h:32-42)
            dt = np.uint8 if bpd == 1 else (">u2" if h.little_endian == 1 else "<u2")
            out = np.empty((area.h, area.w), dtype=np.uint16)
            with open(self.path, "rb") as f:
                if area.x == 0 and area.w == h.width:
                    # full-width rows are contiguous in the file
                    f.seek(offset + area.y * h.width * bpd)
                    raw = np.fromfile(f, dtype=dt, count=area.h * area.w)
                    if raw.size != area.h * area.w:
                        raise ValueError(f"truncated SER frame {frame_no}")
                    return raw.astype(np.uint16).reshape(area.h, area.w)
                for r in range(area.h):
                    f.seek(offset + ((area.y + r) * h.width + area.x) * bpd)
                    out[r] = np.fromfile(f, dtype=dt, count=area.w)
            return out

        if color in (SER_RGB, SER_BGR):
            # rectangular crop of the interleaved planes (the reference
            # reads a contiguous run here — identical for the full-width
            # row blocks it actually passes; divergence in PARITY.md)
            frame = self.read_frame(frame_no, debayer=debayer,
                                    bayer_pattern=bayer_pattern,
                                    bayer_method=bayer_method, device=device)
            layer_img = frame.data[layer][::-1]   # top-down for area coords
            return np.ascontiguousarray(
                layer_img[area.y : area.y + area.h,
                          area.x : area.x + area.w])

        # Bayer: the reference demosaics a WINDOW expanded by 2-3 px with
        # parity preserved (get_debayer_area, demosaicing.c:787-843) and
        # extracts the area from it. The expansion is narrower than VNG's
        # effective support, so values on the first/last row of a block
        # genuinely differ from a full-frame debayer — reproduced exactly
        # (verified against the compiled C in test_c_goldens).
        from siriltpu_torch.ops.demosaic import debayer_buffer, pattern_from_ser

        def expand(pos, length, limit):
            off = 3 if pos & 1 else 2
            start = pos - off
            if start < 0:
                start, off = 0, pos
            end = pos + length - 1
            grow = 2 if end & 1 else 3
            if end + grow >= limit:
                grow = limit - end - 1
            return start, off, length + (pos - start) + grow

        wy0, yoff, wh = expand(area.y, area.h, h.height)
        wx0, xoff, ww = expand(area.x, area.w, h.width)
        raw = self._read_raw_frame(frame_no).reshape(h.height, h.width)
        window = np.ascontiguousarray(raw[wy0 : wy0 + wh, wx0 : wx0 + ww])
        pat = bayer_pattern or pattern_from_ser(color)
        demo = debayer_buffer(window, pat, bayer_method, device=device)  # (3, wh, ww)
        return np.ascontiguousarray(
            demo[layer, yoff : yoff + area.h, xoff : xoff + area.w])

    # ----------------------------------------------------------------- write

    def write_frame(self, frame: Frame, frame_no: Optional[int] = None) -> None:
        """Write a bottom-up Frame (``ser_write_frame_from_fit``, ser.c:973-1063):
        flip back to top-down, interleave planes, honor the endian quirk."""
        h = self.header
        if h.number_of_planes == 0 or (h.width == 0 and h.height == 0):
            # first frame populates the header (ser.c:983-985)
            h.width = frame.rx
            h.height = frame.ry
            h.color_id = SER_RGB if frame.nlayers == 3 else SER_MONO
        if frame.rx != h.width or frame.ry != h.height:
            raise ValueError("Trying to add an image of different size in a SER")
        if frame_no is None:
            frame_no = h.frame_count
        data = frame.data[:, ::-1, :]  # top-down
        n = h.width * h.height
        planes = h.number_of_planes
        if frame.nlayers != planes:
            raise ValueError(f"frame has {frame.nlayers} layers, SER has {planes}")
        inter = data.transpose(1, 2, 0).reshape(-1)  # interleave
        offset = SER_HEADER_LEN + h.frame_nbytes * frame_no
        with open(self.path, "r+b") as f:
            f.seek(offset)
            if h.byte_pixel_depth == 1:
                f.write(inter.astype(np.uint8).tobytes())
            else:
                dt = ">u2" if h.little_endian == 1 else "<u2"
                f.write(inter.astype(dt).tobytes())
        if frame_no >= h.frame_count:
            h.frame_count = frame_no + 1

    def write_and_close(self) -> None:
        """Finalize header + timestamps (``ser_write_and_close``, ser.c)."""
        with open(self.path, "r+b") as f:
            f.write(self.header.pack())
            if self.timestamps:
                f.seek(SER_HEADER_LEN + self.header.frame_nbytes * self.header.frame_count)
                np.asarray(self.timestamps, dtype="<u8").tofile(f)


__all__ = ["SerFile", "SerHeader", "SER_HEADER_LEN", "SER_MONO", "SER_RGB",
           "SER_BGR", "SER_BAYER_RGGB", "SER_BAYER_GRBG", "SER_BAYER_GBRG",
           "SER_BAYER_BGGR", "BAYER_IDS"]
