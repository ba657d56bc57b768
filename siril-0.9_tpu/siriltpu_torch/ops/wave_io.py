"""Wavelet transform disk persistence — byte-interoperable with the
reference's ``.wave`` files.

Port of ``siriltpu.ops.wave_io``, copied without change: the two
packages' ``.wave`` files are equal byte for byte.

Reference: src/algos/io_wave.c — the ``wavelet`` command writes each
channel's à-trous transform to ``[rgb]_rawdata.wave`` files in the tmp
dir which ``wrecons`` re-reads with per-plane weights
(src/core/command.c:443-530).

On-disk format (wave_io_write, io_wave.c:217-272): a raw dump of
``wave_transf_des`` (Def_Wavelet.h:81-94) followed by
``Nbr_Plan * Nl * Nc`` little-endian float32 plane values. On x86-64 the
struct is 440 bytes:

    offset   0  char Name_Imag[100]
    offset 100  int  Nbr_Ligne
    offset 104  int  Nbr_Col
    offset 108  int  Nbr_Plan
    offset 112  int  Type_Wave_Transform
    offset 116  (4 pad) then pyramid_f_des Pyramid (256 B, at 120)
    offset 376  pave_f_des Pave (16 B — contains a heap POINTER)
    offset 392  struct mallat_plan_des Mallat (48 B — five pointers)

Only the five leading fields matter to the reader; the pointer-bearing
tail is garbage in reference-written files (live heap addresses) and is
zeroed in files we write. wave_io_read re-reads geometry from the header
and loads the plane data that follows; it never dereferences the dumped
pointers (io_wave.c:156-211). The struct size is asserted against the
compiled C in tests/test_c_goldens.py.

Files written by siriltpu are therefore readable by the reference and
vice versa. The pre-round-2 private format (``STPUWAV1`` magic) is still
read for compatibility.
"""

from __future__ import annotations

import struct

import numpy as np

_LEGACY_MAGIC = b"STPUWAV1"
_HEADER_SIZE = 440        # sizeof(wave_transf_des) on LP64
_GEOM_OFFSET = 100        # Name_Imag[100] precedes the geometry ints
_NAME_SIZE = 100          # MAX_SIZE_NAME_IMAG (Def_Wavelet.h:31)


def wave_write(path: str, planes: np.ndarray, kind: int,
               name: str | None = None) -> None:
    """Persist an (nplanes, H, W) transform in the reference layout.

    Matches wavelet_transform_file's output byte-for-byte (memset-zero
    descriptor + geometry fields; transform.c:156-172) except that the
    heap-pointer fields the reference leaks into the dump are zeroed —
    wave_io_read never reads them. ``name`` fills Name_Imag (the
    reference stores the output path there; defaults to ``path``)."""
    planes = np.asarray(planes, dtype=np.float32)
    n, h, w = planes.shape
    header = bytearray(_HEADER_SIZE)
    name_b = (path if name is None else name).encode()[: _NAME_SIZE - 1]
    header[: len(name_b)] = name_b
    struct.pack_into("<iiii", header, _GEOM_OFFSET, h, w, n, kind)
    with open(path, "wb") as f:
        f.write(header)
        planes.astype("<f4").tofile(f)


def wave_read(path: str):
    """Returns (planes (n, H, W) float32, kind). Accepts both the
    reference ``.wave`` layout and the legacy siriltpu format."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_SIZE)
        if head[:8] == _LEGACY_MAGIC:
            n, h, w, kind = struct.unpack_from("<iiii", head, 8)
            f.seek(8 + 16)
            planes = np.fromfile(f, dtype=np.float32, count=n * h * w)
        else:
            if len(head) < _HEADER_SIZE:
                raise ValueError(f"truncated wavelet file {path}")
            h, w, n, kind = struct.unpack_from("<iiii", head, _GEOM_OFFSET)
            if not (0 < n < 20 and h > 0 and w > 0 and kind in (1, 2)):
                raise ValueError(f"{path} is not a pave .wave file")
            planes = np.fromfile(f, dtype="<f4", count=n * h * w)
    if planes.size != n * h * w:
        raise ValueError(f"truncated wavelet file {path}")
    return planes.reshape(n, h, w), kind


__all__ = ["wave_write", "wave_read"]
