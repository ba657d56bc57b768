"""``.seq`` sidecar file read/write, byte-compatible with the reference.

Port of ``siriltpu.io.seqfile``, which is plain Python already: copied
without change. Either package reads what the other writes.

Reference: src/io/seqfile.c (readseqfile :43-274, writeseqfile :277-357).

Format (text):

- ``#`` comment lines
- ``S 'name' beg number selnum fixed reference_image``
- ``T<S|A>`` sequence type (absent for regular FITS sequences)
- ``L nb_layers``
- ``I filenum incl [mean median sigma avgDev mad sqrtbwmv location scale min max]``
  one per image, stats optional (10 values)
- ``R<layer> shiftx shifty rot_centre_x rot_centre_y angle fwhm quality``
  one per image per registered layer

This doubles as the checkpoint format: registration data and cached
statistics persist here between stages (SURVEY §5.4).
"""

from __future__ import annotations

import os
import re
from typing import TYPE_CHECKING

from siriltpu_torch.core.frame import ImStats, ImgParam, RegData

if TYPE_CHECKING:
    from siriltpu_torch.io.sequence import Sequence


def _fmt_g(x: float) -> str:
    """printf %g formatting."""
    return f"{x:g}"


def write_seqfile(seq: "Sequence", directory: str = ".") -> str:
    path = os.path.join(directory, seq.seqname + ".seq")
    lines = [
        "#Siril sequence file. Contains list of files (images), selection, and registration data",
        "#S 'sequence_name' start_index nb_images nb_selected fixed_len reference_image",
        f"S '{seq.seqname}' {seq.beg} {seq.number} {seq.selnum} {seq.fixed} {seq.reference_image}",
    ]
    if seq.seqtype != "regular":
        lines.append("T" + ("S" if seq.seqtype == "ser" else "A"))
    lines.append(f"L {seq.nb_layers}")
    for p in seq.imgparam:
        if p.stats is not None:
            s = p.stats
            lines.append(
                "I {} {} {} {} {} {} {} {} {} {} {} {}".format(
                    p.filenum, int(p.incl), _fmt_g(s.mean), _fmt_g(s.median),
                    _fmt_g(s.sigma), _fmt_g(s.avgdev), _fmt_g(s.mad),
                    _fmt_g(s.sqrtbwmv), _fmt_g(s.location), _fmt_g(s.scale),
                    _fmt_g(s.min), _fmt_g(s.max)))
        else:
            lines.append(f"I {p.filenum} {int(p.incl)}")
    for layer in range(seq.nb_layers):
        reg = seq.regparam.get(layer)
        if reg:
            for r in reg:
                lines.append(
                    "R{} {} {} {} {} {} {} {}".format(
                        layer, r.shiftx, r.shifty, _fmt_g(r.rot_centre_x),
                        _fmt_g(r.rot_centre_y), _fmt_g(r.angle),
                        _fmt_g(r.fwhm), _fmt_g(r.quality)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    seq.needs_saving = False
    return path


def read_seqfile(path: str) -> "Sequence":
    from siriltpu_torch.io.sequence import Sequence

    if not path.endswith(".seq"):
        path = path + ".seq"
    seq = Sequence()
    with open(path) as f:
        reg_count = {}
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            tag = line[0]
            if tag == "S":
                m = re.match(r"S '(.*)' (-?\d+) (-?\d+) (-?\d+) (-?\d+)(?: (-?\d+))?", line)
                if not m:
                    raise ValueError(f"bad S line in {path}: {line}")
                seq.seqname = m.group(1)
                seq.beg = int(m.group(2))
                seq.number = int(m.group(3))
                seq.selnum = int(m.group(4))
                seq.fixed = int(m.group(5))
                seq.reference_image = int(m.group(6)) if m.group(6) else -1
                seq.imgparam = []
            elif tag == "T":
                seq.seqtype = "ser" if line[1:2] == "S" else "film"
            elif tag == "L":
                seq.nb_layers = int(line.split()[1])
            elif tag == "I":
                if len(seq.imgparam) >= seq.number:
                    # the reference writes imgparam[i] past its allocation
                    # here (UB); refuse the extra lines instead
                    raise ValueError(
                        f"{path}: more I lines than the S line's nb_images")
                parts = line.split()
                p = ImgParam(filenum=int(parts[1]), incl=bool(int(parts[2])))
                if len(parts) >= 13:
                    vals = [float(v) for v in parts[3:13]]
                    p.stats = ImStats(
                        mean=vals[0], median=vals[1], sigma=vals[2],
                        avgdev=vals[3], mad=vals[4], sqrtbwmv=vals[5],
                        location=vals[6], scale=vals[7], min=vals[8],
                        max=vals[9])
                seq.imgparam.append(p)
            elif tag == "R":
                layer = int(line[1:].split()[0]) if line[1] != " " else 0
                # R<layer> is glued: "R0 sx sy ..."
                m = re.match(r"R(\d+) (.*)", line)
                layer = int(m.group(1))
                vals = m.group(2).split()
                lst = seq.regparam.setdefault(layer, [])
                if len(lst) >= seq.number:
                    continue
                lst.append(RegData(
                    shiftx=int(float(vals[0])), shifty=int(float(vals[1])),
                    rot_centre_x=float(vals[2]), rot_centre_y=float(vals[3]),
                    angle=float(vals[4]), fwhm=float(vals[5]),
                    quality=float(vals[6])))
    if seq.number <= 0 or not seq.imgparam:
        # readseqfile: "The file seems to be corrupted" (seqfile.c:249)
        raise ValueError(f"{path}: corrupted sequence file (no S/I data)")
    if len(seq.imgparam) != seq.number:
        raise ValueError(
            f"{path}: S line declares {seq.number} images, found "
            f"{len(seq.imgparam)} I lines")
    nbsel = sum(1 for p_ in seq.imgparam if p_.incl)
    if nbsel != seq.selnum:
        # reference fixes the count in memory without saving
        # (seqfile.c:258-261)
        seq.selnum = nbsel
    seq.seq_dir = os.path.dirname(os.path.abspath(path))
    seq.needs_saving = False
    return seq


__all__ = ["read_seqfile", "write_seqfile"]
