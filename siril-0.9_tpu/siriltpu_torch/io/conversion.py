"""Conversion subsystem: any supported input → FITS sequence or SER.

Port of ``siriltpu.io.conversion``: the SER and image-format branches,
copied. Films and DSLR raw files are not ported yet: their branches raise
``NotImplementedError`` naming ``io/films.py`` and ``io/raw.py``.

Reference: src/io/conversion.c — flags CONV1X3/3X1/1X1, CONVDSTSER,
CONVMULTIPLE (src/core/siril.h:155-163), worker ``convert_thread_worker``
(:509-662), ``debayer_if_needed`` (:736), ``any_to_fits`` (:802), and the
raw-extension table with per-vendor Bayer patterns (:51-74).

Inputs: SER (split into frames), PNM, BMP, PIC, and PNG/JPG/TIFF via
imageio.
"""

from __future__ import annotations

import os
from typing import List, Optional


from siriltpu_torch.core.frame import Frame
from siriltpu_torch.io import fits as fits_io
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

#: film containers (``siriltpu.io.films.FILM_EXTENSIONS``), kept here until
#: the port has ``io/films.py``
FILM_EXTENSIONS = ("avi", "mpg", "mpeg", "mp4", "webm", "mov", "mkv")

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


def convert_dir(directory: str, basename: str, *, to_ser: bool = False,
                fits_ext: str = "fit", debayer: bool = False,
                settings=None) -> int:
    """Convert every supported file in ``directory`` into a numbered FITS
    sequence ``<basename>NNNNN.<ext>`` (or one SER when ``to_ser``).
    ``settings`` drives the raw branch, which is not ported yet."""
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
                frames.append(ser.read_frame(i, debayer=debayer))
        elif ext in FILM_EXTENSIONS:
            # the film branch of convert_thread_worker (conversion.c:551-600)
            raise NotImplementedError(
                f"converting the film {os.path.basename(path)} needs "
                "io/films.py, which siriltpu_torch does not port yet")
        elif ext in RAW_EXTENSIONS:
            # readraw_in_cfa / readraw (conversion.c:736-802)
            raise NotImplementedError(
                f"converting the raw file {os.path.basename(path)} needs "
                "io/raw.py, which siriltpu_torch does not port yet")
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


__all__ = ["convert_dir", "convertible_files", "RAW_EXTENSIONS",
           "FILM_EXTENSIONS"]
