"""Sequence abstraction: a named, ordered set of frames with registration
data and cached statistics.

Port of ``siriltpu.io.sequence``, which is NumPy already: copied without
change, but for two things. Films: their reader (``io/films.py``) is not
ported yet, so ``check_seq`` raises ``NotImplementedError`` on a directory
that holds one. And a SER sequence carries ``debayer_device``, the device
its reads debayer a large frame on by VNG or AHD (``ops/demosaic.py``).

Reference: src/io/sequence.c (struct sequ src/core/siril.h:328-374,
discovery ``check_seq`` :145-280, frame access :519-690, stats cache
``seq_get_imstats`` :1107) and src/io/seqfile.c persistence.

Sequence types:
- ``regular``: numbered FITS files ``<base><NNN>.<ext>``
- ``ser``: one SER video file
- ``internal``: in-memory frames (compositing, src/io/sequence.h:48)

Frames are returned as uint16 bottom-up ``Frame``s; partial reads return
TOP-DOWN row blocks like the reference partial readers (the stacking
engine's area coordinates, see io/fits.py and io/ser.py).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from siriltpu_torch.core.frame import Frame, ImStats, ImgParam, Rect, RegData
from siriltpu_torch.io import fits as fits_io
from siriltpu_torch.io.ser import SerFile


@dataclass
class Sequence:
    seqname: str = ""
    seqtype: str = "regular"  # regular | ser | film | internal
    beg: int = 0
    end: int = 0
    number: int = 0
    selnum: int = 0
    fixed: int = 1  # fixed length of image index in filename
    reference_image: int = -1
    nb_layers: int = -1
    rx: int = 0
    ry: int = 0
    ext: str = "fit"
    seq_dir: str = "."
    imgparam: List[ImgParam] = field(default_factory=list)
    regparam: Dict[int, List[RegData]] = field(default_factory=dict)
    needs_saving: bool = False
    # ser / internal backing
    ser: Optional[SerFile] = None
    internal_frames: Optional[List[Frame]] = None
    # debayer options for SER reads
    debayer: bool = False
    bayer_pattern: Optional[str] = None
    bayer_method: str = "bilinear"
    debayer_device: Optional[str] = None

    # --------------------------------------------------------------- naming

    def image_filename(self, index: int) -> str:
        """Filename of image ``index`` (reference ``fit_sequence_get_image_filename``)."""
        if self.seqtype == "ser":
            return self.seqname + ".ser"
        num = self.imgparam[index].filenum if index < len(self.imgparam) else index
        return f"{self.seqname}{num:0{self.fixed}d}.{self.ext}"

    def image_path(self, index: int) -> str:
        return os.path.join(self.seq_dir, self.image_filename(index))

    # -------------------------------------------------------------- reading

    def _ensure_geometry(self, frame: Frame) -> None:
        if self.nb_layers == -1 or self.rx == 0:
            self.nb_layers = frame.nlayers
            self.rx = frame.rx
            self.ry = frame.ry

    def read_frame(self, index: int) -> Frame:
        """Full frame read (``seq_read_frame``, src/io/sequence.c:519-565)."""
        if self.seqtype == "internal":
            return self.internal_frames[index]
        if self.seqtype == "ser":
            self._open_ser()
            frame = self.ser.read_frame(index, debayer=self.debayer,
                                        bayer_pattern=self.bayer_pattern,
                                        bayer_method=self.bayer_method,
                                        device=self.debayer_device)
        else:
            frame = fits_io.read_fits(self.image_path(index))
        self._ensure_geometry(frame)
        return frame

    def read_frame_part(self, index: int, layer: int, area: Rect) -> np.ndarray:
        """Partial read of one layer, rows top-down
        (``seq_read_frame_part`` / ``seq_opened_read_region``,
        src/io/sequence.c:567-690)."""
        if self.seqtype == "internal":
            img = self.internal_frames[index].data[layer][::-1]  # to top-down
            return np.ascontiguousarray(
                img[area.y : area.y + area.h, area.x : area.x + area.w])
        if self.seqtype == "ser":
            self._open_ser()
            return self.ser.read_opened_partial(
                layer, index, area, debayer=self.debayer,
                bayer_pattern=self.bayer_pattern, bayer_method=self.bayer_method,
                device=self.debayer_device)
        return fits_io.read_fits_partial(self.image_path(index), layer, area)

    def _open_ser(self) -> None:
        if self.ser is None:
            self.ser = SerFile.open(os.path.join(self.seq_dir, self.seqname + ".ser"))
            if self.rx == 0:
                self.rx = self.ser.header.width
                self.ry = self.ser.header.height
                planes = 3 if (self.debayer and self.ser.header.color_id != 0) \
                    else self.ser.header.number_of_planes
                if self.nb_layers == -1:
                    self.nb_layers = planes

    # ---------------------------------------------------------- stats cache

    def get_imstats(self, index: int, layer: int = 0, *,
                    compute=None) -> Optional[ImStats]:
        """Cached per-image statistics (``seq_get_imstats``,
        src/io/sequence.c:1107-1118). ``compute`` is called with the Frame
        if the cache is empty; new stats flip ``needs_saving``."""
        p = self.imgparam[index]
        if p.stats is None and compute is not None:
            p.stats = compute(self.read_frame(index))
            self.needs_saving = True
        return p.stats

    def clear_stats(self) -> None:
        for p in self.imgparam:
            p.stats = None

    # ----------------------------------------------------------- registration

    def reg_shifts(self, layer: int) -> np.ndarray:
        """(number, 2) int array of (shiftx, shifty); zeros if unregistered."""
        reg = self.regparam.get(layer)
        if not reg:
            return np.zeros((self.number, 2), dtype=np.int32)
        return np.array([[r.shiftx, r.shifty] for r in reg], dtype=np.int32)

    def ensure_regparam(self, layer: int) -> List[RegData]:
        if layer not in self.regparam or len(self.regparam[layer]) != self.number:
            self.regparam[layer] = [RegData() for _ in range(self.number)]
        return self.regparam[layer]

    # ------------------------------------------------------------- selection

    def included_indices(self) -> List[int]:
        return [i for i, p in enumerate(self.imgparam) if p.incl]

    def set_included(self, index: int, incl: bool) -> None:
        if self.imgparam[index].incl != incl:
            self.imgparam[index].incl = incl
            self.selnum += 1 if incl else -1
            self.needs_saving = True


# -------------------------------------------------------------- constructors

def internal_sequence(frames: List[Frame], name: str = "internal") -> Sequence:
    """In-memory sequence (``create_internal_sequence``, compositing)."""
    seq = Sequence(seqname=name, seqtype="internal", number=len(frames),
                   selnum=len(frames), internal_frames=frames)
    seq.imgparam = [ImgParam(filenum=i) for i in range(len(frames))]
    if frames:
        seq.nb_layers = frames[0].nlayers
        seq.rx = frames[0].rx
        seq.ry = frames[0].ry
    return seq


def ser_sequence(path: str, *, debayer: bool = False,
                 bayer_pattern: Optional[str] = None,
                 debayer_device=None) -> Sequence:
    ser = SerFile.open(path)
    base = os.path.basename(path)
    name = base[:-4] if base.lower().endswith(".ser") else base
    seq = Sequence(seqname=name, seqtype="ser", number=ser.frame_count,
                   selnum=ser.frame_count, seq_dir=os.path.dirname(os.path.abspath(path)) or ".",
                   ser=ser, debayer=debayer, bayer_pattern=bayer_pattern,
                   debayer_device=debayer_device)
    seq.imgparam = [ImgParam(filenum=i) for i in range(ser.frame_count)]
    seq.rx = ser.header.width
    seq.ry = ser.header.height
    seq.nb_layers = 3 if (debayer and ser.header.color_id != 0) else ser.header.number_of_planes
    return seq


_NUM_RE = re.compile(r"^(.*?)(\d+)\.([^.]+)$")


def get_index_and_basename(filename: str):
    """Parse ``<base><digits>.<ext>`` (reference ``get_index_and_basename``,
    src/io/sequence.c:770-810). Returns (basename, index, fixed_len, ext)."""
    m = _NUM_RE.match(os.path.basename(filename))
    if not m:
        return None
    base, digits, ext = m.groups()
    return base, int(digits), len(digits), ext


#: containers the reference discovers as film sequences
#: (check_for_film_extensions, sequence.c:231-247)
FILM_EXTENSIONS = ("avi", "mpg", "mpeg", "mp4", "webm", "mov", "mkv")


def check_seq(directory: str = ".", *, force: bool = False,
              extensions=("fit", "fits", "fts")) -> List[Sequence]:
    """Scan a directory for image sequences and build ``.seq`` files
    (reference ``check_seq``, src/io/sequence.c:145-280 +
    ``buildseqfile`` seqfile.c:374).

    Groups numbered FITS files by basename, plus every ``.ser`` file;
    a film file raises ``NotImplementedError``. Existing ``.seq`` files are kept unless ``force``.
    """
    from siriltpu_torch.io.seqfile import read_seqfile, write_seqfile

    sequences: List[Sequence] = []
    groups: Dict[tuple, List[tuple]] = {}
    for path in sorted(os.listdir(directory)):
        full = os.path.join(directory, path)
        if not os.path.isfile(full):
            continue
        low = path.lower()
        if low.endswith(".ser"):
            seq = ser_sequence(full)
            sequences.append(seq)
            continue
        if any(low.endswith("." + e) for e in FILM_EXTENSIONS):
            # films are sequences too (reference check_seq discovers
            # them via check_for_film_extensions, sequence.c:231-247)
            raise NotImplementedError(
                f"{path}: film sequences are not ported to siriltpu_torch "
                "yet: they need io/films.py")
        if not any(low.endswith("." + e) for e in extensions):
            continue
        parsed = get_index_and_basename(path)
        if not parsed:
            continue
        base, idx, fixed, ext = parsed
        groups.setdefault((base, ext), []).append((idx, fixed))

    for (base, ext), items in groups.items():
        if len(items) < 2:
            continue
        items.sort()
        seqname = base
        seqpath = os.path.join(directory, seqname + ".seq")
        if os.path.exists(seqpath) and not force:
            try:
                seq = read_seqfile(seqpath)
                seq.ext = ext
                sequences.append(seq)
                continue
            except (ValueError, OSError):
                pass
        seq = Sequence(seqname=seqname, seqtype="regular", seq_dir=directory,
                       beg=items[0][0], end=items[-1][0], number=len(items),
                       selnum=len(items), fixed=items[0][1], ext=ext)
        seq.imgparam = [ImgParam(filenum=idx) for idx, _ in items]
        write_seqfile(seq, directory)
        sequences.append(seq)

    return sequences


__all__ = ["Sequence", "internal_sequence", "ser_sequence", "check_seq",
           "get_index_and_basename"]
