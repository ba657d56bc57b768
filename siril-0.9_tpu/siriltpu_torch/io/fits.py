"""Pure-NumPy FITS reader/writer, bit-compatible with Siril's conventions.

Port of ``siriltpu.io.fits``, which is NumPy already: copied without
change, but for ``read_fits_partial``, which reads an area that spans the
full width in one piece instead of row by row.

Replaces cfitsio usage in the reference (src/io/image_format_fits.c):

- ``read_fits`` mirrors ``readfits`` (:176-384): any BITPIX is converted to
  uint16 "WORD" data with the same range heuristics
  (:287-349, float [0,1] detection :334-348).
- ``write_fits`` mirrors ``savefits`` (:652-738): 8/16-bit unsigned output,
  BZERO=32768 convention for 16-bit, header keys from ``save_fits_header``
  (:741-840) where applicable.
- Data is kept in FITS file row order (bottom-to-top); ``readfits`` does not
  flip (:291-349), neither do we.

The codec supports the FITS subset Siril reads/writes: primary HDU only,
BITPIX in {8, 16, 32, -32, -64}, NAXIS in {2, 3}.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np

from siriltpu_torch.core.frame import Frame, Rect
from siriltpu_torch.utils.rounding import np_round_to_word

CARD_LEN = 80
BLOCK_LEN = 2880


# ----------------------------------------------------------------- header I/O

def _parse_card(card: bytes) -> Optional[Tuple[str, object, str]]:
    """Parse one 80-byte header card into (key, value, comment)."""
    key = card[:8].decode("ascii", "replace").strip()
    if not key or key in ("COMMENT", "HISTORY", "END"):
        return None
    if card[8:10] != b"= ":
        return None
    body = card[10:].decode("ascii", "replace")
    # strip comment
    comment = ""
    if body.lstrip().startswith("'"):
        # string value: find closing quote ('' escapes)
        s = body.lstrip()
        i, out = 1, []
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        value: object = "".join(out).rstrip()
        rest = s[i + 1 :]
        if "/" in rest:
            comment = rest.split("/", 1)[1].strip()
    else:
        if "/" in body:
            valstr, comment = body.split("/", 1)
            comment = comment.strip()
        else:
            valstr = body
        valstr = valstr.strip()
        if valstr in ("T", "F"):
            value = valstr == "T"
        else:
            try:
                value = int(valstr)
            except ValueError:
                try:
                    value = float(valstr.replace("D", "E").replace("d", "e"))
                except ValueError:
                    value = valstr
    return key, value, comment


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_header_stream(f)[0]


def _read_header_stream(f) -> Tuple[dict, int]:
    """Read header blocks until END; returns (header dict, data offset)."""
    header: dict = {}
    while True:
        block = f.read(BLOCK_LEN)
        if len(block) < BLOCK_LEN:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, BLOCK_LEN, CARD_LEN):
            card = block[i : i + CARD_LEN]
            if card[:3] == b"END" and card[3:8].strip() == b"":
                done = True
                break
            parsed = _parse_card(card)
            if parsed:
                header[parsed[0]] = parsed[1]
        if done:
            break
    return header, f.tell()


_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _convert_to_word(raw: np.ndarray, bitpix: int, bzero: float, bscale: float) -> np.ndarray:
    """Convert raw FITS data to uint16 following readfits's rules.

    Reference: src/io/image_format_fits.c:287-349.
    """
    if bitpix == 8:
        phys = bzero + bscale * raw.astype(np.float64)
        # cfitsio TBYTE conversion clips to [0, 255]
        out = np.clip(np.rint(phys), 0, 255).astype(np.uint16)
        return out
    if bitpix == 16:
        if bzero == 32768 and bscale == 1:
            # USHORT_IMG path (:298)
            return (raw.astype(np.int32) + 32768).astype(np.uint16)
        # SHORT_IMG read as TSHORT into a WORD buffer: values wrap mod 65536
        phys = bzero + bscale * raw.astype(np.float64)
        phys = np.clip(np.rint(phys), -32768, 32767).astype(np.int16)
        return phys.astype(np.uint16)  # bit reinterpretation (C wrap)
    if bitpix == 32:
        # reference reads TLONG (cfitsio applies BZERO) then rescales (:304-325)
        offset = bzero
        phys = np.clip(raw.astype(np.float64) * bscale + offset, -2147483648, 2147483647)
        m = phys.max() if phys.size else 0.0
        shift = (0x80000000 - offset) / 4294967295.0
        if m > 65535.0:
            return np_round_to_word((phys / 4294967295.0 + shift) * 65535.0)
        return np_round_to_word(phys + shift)
    if bitpix in (-32, -64):
        phys = bzero + bscale * raw.astype(np.float64)
        m = phys.max() if phys.size else 0.0
        # float [0,1] range detection (:334-348)
        if m > 1.0:
            return np_round_to_word(phys)
        return np_round_to_word(65535.0 * phys)
    raise ValueError(f"Unsupported FITS BITPIX {bitpix}")


def read_fits(path: str) -> Frame:
    """Read a FITS file into a uint16 Frame (bottom-up row order).

    Mirrors ``readfits`` (src/io/image_format_fits.c:176-384).
    """
    with open(path, "rb") as f:
        header, offset = _read_header_stream(f)
        bitpix = int(header["BITPIX"])
        naxis = int(header["NAXIS"])
        if naxis not in (2, 3):
            raise ValueError(f"FITS with NAXIS={naxis} not supported")
        w = int(header["NAXIS1"])
        h = int(header["NAXIS2"])
        c = int(header.get("NAXIS3", 1)) if naxis == 3 else 1
        if c not in (1, 3):
            raise ValueError(f"FITS with {c} layers not supported")
        bzero = float(header.get("BZERO", 0))
        bscale = float(header.get("BSCALE", 1))
        dtype = _BITPIX_DTYPE[bitpix]
        count = w * h * c
        raw = np.fromfile(f, dtype=dtype, count=count)
        if raw.size != count:
            raise ValueError(f"truncated FITS data in {path}")
    data = _convert_to_word(raw, bitpix, bzero, bscale).reshape(c, h, w)
    meta = {
        "exposure": float(header.get("EXPTIME", header.get("EXPOSURE", 0.0)) or 0.0),
        "date_obs": header.get("DATE-OBS", ""),
        "instrume": header.get("INSTRUME", ""),
        "lo": int(header.get("MIPS-LO", 0) or 0),
        "hi": int(header.get("MIPS-HI", 0) or 0),
        # DFT keys (src/core/siril.h:427-430), used by FFTD/FFTI round trip
        "dft_norm": [header.get(f"DFTNORM{i}", None) for i in (1, 2, 3)],
        "dft_ord": header.get("DFTORD", ""),
        "dft_type": header.get("DFTTYPE", ""),
        "dft_rx": int(header.get("DFTRX", 0) or 0),
        "dft_ry": int(header.get("DFTRY", 0) or 0),
    }
    return Frame(data, meta)


def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20G}"
    else:
        body = f"{key:<8}= '{value}'"
    if comment:
        body += f" / {comment}"
    return body[:CARD_LEN].ljust(CARD_LEN).encode("ascii")


def write_fits(path: str, frame: Frame, *, bitpix: int = 16) -> None:
    """Write a Frame as a FITS file, Siril-style.

    Mirrors ``savefits`` (src/io/image_format_fits.c:652-738): 16-bit
    unsigned data written as BITPIX=16 / BZERO=32768, existing file
    replaced, selected header keys appended (``save_fits_header`` :741).
    """
    if bitpix not in (8, 16):
        raise ValueError("Siril writes BYTE/USHORT FITS only")
    data = frame.data
    c, h, w = data.shape
    cards = [
        _card("SIMPLE", True, "file conforms to FITS standard"),
        _card("BITPIX", bitpix, "number of bits per data pixel"),
        _card("NAXIS", 3 if c == 3 else 2, "number of data axes"),
        _card("NAXIS1", w, "length of data axis 1"),
        _card("NAXIS2", h, "length of data axis 2"),
    ]
    if c == 3:
        cards.append(_card("NAXIS3", c, "length of data axis 3"))
    if bitpix == 16:
        cards.append(_card("BZERO", 32768, "offset data range to that of unsigned short"))
        cards.append(_card("BSCALE", 1, "default scaling factor"))
    meta = frame.meta or {}
    if meta.get("lo") or meta.get("hi"):
        cards.append(_card("MIPS-LO", int(meta.get("lo", 0)), "Lower visualization cutoff"))
        cards.append(_card("MIPS-HI", int(meta.get("hi", 0)), "Upper visualization cutoff"))
    if meta.get("exposure"):
        cards.append(_card("EXPTIME", float(meta["exposure"]), "Exposure time [s]"))
    if meta.get("date_obs"):
        cards.append(_card("DATE-OBS", meta["date_obs"], "Date of observation"))
    if meta.get("instrume"):
        cards.append(_card("INSTRUME", meta["instrume"], "Instrument"))
    if meta.get("dft_type"):
        cards.append(_card("DFTTYPE", meta["dft_type"], "Module/Phase of a Discrete Fourier Transform"))
        cards.append(_card("DFTORD", meta.get("dft_ord", ""), "Low/High spatial freq. are located at image center"))
        for i, v in enumerate(meta.get("dft_norm") or []):
            if v is not None:
                cards.append(_card(f"DFTNORM{i+1}", float(v), "Normalisation value"))
        if meta.get("dft_rx"):
            cards.append(_card("DFTRX", int(meta["dft_rx"]), "Original width"))
            cards.append(_card("DFTRY", int(meta["dft_ry"]), "Original height"))
    cards.append(_card("DATE", datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%S"),
                       "UTC date that FITS file was created"))
    cards.append(b"END".ljust(CARD_LEN))
    header = b"".join(cards)
    header += b" " * (-len(header) % BLOCK_LEN)

    if bitpix == 16:
        payload = (data.astype(np.int32) - 32768).astype(">i2").tobytes()
    else:
        payload = np.clip(data, 0, 255).astype(">u1").tobytes()
    payload += b"\x00" * (-len(payload) % BLOCK_LEN)

    if os.path.exists(path):
        os.unlink(path)  # savefits unlinks existing output (:676)
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)


def read_fits_partial(path: str, layer: int, area: Rect) -> np.ndarray:
    """Read one layer's rectangular region (top-down coords, rows returned
    top-down like ``read_opened_fits_partial``, src/io/image_format_fits.c:581-638).

    Only 8/16-bit Siril FITS files are supported (as in the reference
    ``readfits_partial`` :536-545).
    """
    with open(path, "rb") as f:
        header, offset = _read_header_stream(f)
        bitpix = int(header["BITPIX"])
        if bitpix not in (8, 16):
            raise ValueError("partial read only supported for Siril 8/16-bit FITS")
        w = int(header["NAXIS1"])
        h = int(header["NAXIS2"])
        bzero = float(header.get("BZERO", 0))
        itemsize = 1 if bitpix == 8 else 2
        # file rows for top-down area: [h - y - ah, h - y)
        y0 = h - area.y - area.h
        if y0 < 0 or area.x < 0 or area.x + area.w > w or area.y < 0:
            raise ValueError(f"partial read {area} out of bounds ({w}x{h})")
        plane_off = offset + layer * w * h * itemsize
        dt = np.dtype(">u1") if bitpix == 8 else np.dtype(">i2")
        def to_word(raw):
            if bitpix == 16 and bzero == 32768:
                return (raw.astype(np.int32) + 32768).astype(np.uint16)
            return raw.astype(np.uint16)

        if area.w == w:
            # full-width rows are contiguous in the file
            f.seek(plane_off + y0 * w * itemsize)
            raw = np.fromfile(f, dtype=dt, count=area.h * w)
            if raw.size != area.h * w:
                raise ValueError(f"truncated FITS data in {path}")
            return np.ascontiguousarray(to_word(raw).reshape(area.h, w)[::-1])
        rows = np.empty((area.h, area.w), dtype=np.uint16)
        for r in range(area.h):
            f.seek(plane_off + ((y0 + r) * w + area.x) * itemsize)
            rows[area.h - 1 - r] = to_word(np.fromfile(f, dtype=dt, count=area.w))
    return rows


__all__ = ["read_fits", "write_fits", "read_fits_partial", "read_header"]
