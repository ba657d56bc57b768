"""Conversion subsystem: any supported input → FITS sequence or SER.

Port of ``siriltpu.io.conversion``: copied, but ``convert_dir`` takes the
``device`` that a large VNG or AHD debayer runs on (``io.raw.read_raw``,
``io.ser``).

Reference: src/io/conversion.c — flags CONV1X3/3X1/1X1, CONVDSTSER,
CONVMULTIPLE (src/core/siril.h:155-163), worker ``convert_thread_worker``
(:509-662), ``debayer_if_needed`` (:736), ``any_to_fits`` (:802), and the
raw-extension table with per-vendor Bayer patterns (:51-74).

Inputs: FITS, SER (split into frames), PNM, BMP/PNG/JPG/TIFF via
imageio, and DSLR raw (CR2/NEF/ARW/... via rawpy when available;
uncompressed DNG always, through the built-in decoder in io/raw.py).
"""

from __future__ import annotations

import os
from typing import List, Optional


from siriltpu_torch.core.frame import Frame
from siriltpu_torch.io import fits as fits_io
from siriltpu_torch.io.films import FILM_EXTENSIONS
from siriltpu_torch.io.formats import load_any
from siriltpu_torch.io.ser import SerFile

RAW_EXTENSIONS = {
    # supported_raw[] with per-vendor default Bayer pattern
    # (conversion.c:51-74); None = BAYER_FILTER_NONE (untested/unsupported
    # pattern in the reference)
    "dng": "RGGB", "mos": "RGGB", "cr2": "RGGB", "crw": "RGGB",
    "bay": None, "erf": "RGGB", "raf": "GBRG", "3fr": "GRBG",
    "kdc": "GRBG", "dcr": "GRBG", "mef": "RGGB", "mrw": "RGGB",
    "nef": "RGGB", "nrw": "RGGB", "orf": "GRBG", "raw": "RGGB",
    "rw2": "BGGR", "pef": "BGGR", "ptx": None, "x3f": None,
    "srw": "BGGR", "arw": "RGGB",
}

IMAGE_EXTENSIONS = ("png", "jpg", "jpeg", "tif", "tiff", "bmp", "ppm",
                    "pgm", "pnm", "pic")


def convertible_files(directory: str) -> List[str]:
    out = []
    for name in sorted(os.listdir(directory)):
        low = name.lower()
        ext = low.rsplit(".", 1)[-1] if "." in low else ""
        if (ext in IMAGE_EXTENSIONS or ext in RAW_EXTENSIONS or
                ext == "ser" or ext in FILM_EXTENSIONS):
            out.append(os.path.join(directory, name))
    return out


def convert_dir(directory: str, basename: str, *, device,
                to_ser: bool = False, fits_ext: str = "fit",
                debayer: bool = False, settings=None) -> int:
    """Convert every supported file in ``directory`` into a numbered FITS
    sequence ``<basename>NNNNN.<ext>`` (or one SER when ``to_ser``). A VNG
    or AHD debayer of 2^20 pixels or more, of a raw file or a CFA SER, runs
    on ``device`` (None refuses it)."""
    files = convertible_files(directory)
    index = 1
    ser_out: Optional[SerFile] = None
    for path in files:
        low = path.lower()
        ext = low.rsplit(".", 1)[-1]
        frames: List[Frame] = []
        if ext == "ser":
            ser = SerFile.open(path)
            for i in range(ser.frame_count):
                frames.append(ser.read_frame(i, debayer=debayer, device=device))
        elif ext in FILM_EXTENSIONS:
            # film → frames, like the reference's film branch of
            # convert_thread_worker (conversion.c:551-600)
            from siriltpu_torch.io.films import FilmFile
            try:
                film = FilmFile.open(path)
            except RuntimeError as exc:
                print(f"Skipping {os.path.basename(path)}: {exc}")
                continue
            for i in range(film.nb_frames):
                frames.append(film.read_frame(i))
        elif ext in RAW_EXTENSIONS:
            # readraw_in_cfa / readraw via rawpy or the built-in DNG
            # decoder (io/raw.py). The decoder's own pattern (from
            # CFAPattern / the libraw filter descriptor) wins over the
            # per-vendor default, like use_bayer_header
            # (conversion.c:753-767).
            from siriltpu_torch.io.raw import read_raw
            try:
                frame = read_raw(path, cfa=not debayer, settings=settings,
                                 device=device)
            except (ValueError, OSError) as exc:
                print(f"Skipping {os.path.basename(path)}: {exc}")
                continue
            if frame.meta.get("bayer_pattern") is None and \
                    RAW_EXTENSIONS[ext]:
                frame.meta["bayer_pattern"] = RAW_EXTENSIONS[ext]
            frames.append(frame)
        else:
            frame = load_any(path)
            if frame is None:
                continue
            frames.append(frame)
        for frame in frames:
            if to_ser:
                if ser_out is None:
                    ser_out = SerFile.create(
                        os.path.join(directory, basename + ".ser"),
                        width=frame.rx, height=frame.ry,
                        color_id=100 if frame.nlayers == 3 else 0)
                ser_out.write_frame(frame)
            else:
                dest = os.path.join(directory,
                                    f"{basename}{index:05d}.{fits_ext}")
                fits_io.write_fits(dest, frame)
            index += 1
    if ser_out is not None:
        ser_out.write_and_close()
    return index - 1


__all__ = ["convert_dir", "convertible_files", "RAW_EXTENSIONS"]
