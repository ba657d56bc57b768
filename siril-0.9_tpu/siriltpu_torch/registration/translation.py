"""Translation-family registration of a sequence: DFT phase correlation.

Port of ``siriltpu.registration.translation``. Reference:
src/registration/registration.c — ``register_shift_dft`` (:182-400). It
produces per-frame regdata {shiftx, shifty, quality} on the chosen layer;
qualities are normalized to [0, 1] afterwards (``normalizeQualityData``
:163-176). Consumers apply shifts as ``out(y, x) = frame(y - shifty, x -
shiftx)`` in bottom-up rows.

Row-order note: the reference reads FITS selections bottom-up
(``readfits_partial`` does not flip) but SER selections top-down
(``ser_read_opened_partial``), which flips the sign of the DFT shifty for
SER sequences — a latent reference bug that would misalign SER stacks.
We read ALL selections bottom-up (the self-consistent FITS convention),
so shifts always align the stack regardless of container format.

The selections are read and their quality estimated on the host, in
float64 NumPy as in ``siriltpu`` (the batched float32 estimate on the
device rounds differently); the phase correlation runs on ``device``.

``register_ecc`` (registration.c:786-930) is not ported yet: it needs
``ops/ecc.py`` and the OpenCV glue of ``ops/interp.py`` (ROADMAP.md Queue
1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from siriltpu_torch.core.frame import Rect, select_area
from siriltpu_torch.ops.fftreg import register_shift_frames
from siriltpu_torch.ops.quality import (QUALTYPE_NORMAL, normalize_quality,
                                        quality_estimate)


def _ref_index(seq) -> int:
    return seq.reference_image if seq.reference_image >= 0 else 0


def _selection_bottom_up(seq, index: int, layer: int, sel: Rect) -> np.ndarray:
    """Read a selection in bottom-up row order (see module docstring)."""
    frame = seq.read_frame(index)
    return np.ascontiguousarray(select_area(frame.layer(layer), sel))


@dataclass
class RegistrationReport:
    best_frame: int
    failed: int = 0


def register_shift_dft(seq, layer: int, selection: Rect, *, device,
                       process_all_frames: bool = True,
                       chunk: int = 64) -> RegistrationReport:
    """FFT phase-correlation registration on a square selection
    (``register_shift_dft``, registration.c:182-400), the transforms on
    ``device``.

    Fills seq.regparam[layer] with integer shifts and the PIPP quality of
    each frame's selection, normalized to [0, 1]."""
    if selection.w != selection.h:
        raise ValueError("the selection needs to be squared for the DFT")
    reg = seq.ensure_regparam(layer)
    ref_image = _ref_index(seq)
    indices = [i for i in range(seq.number)
               if process_all_frames or seq.imgparam[i].incl]

    ref_sel = _selection_bottom_up(seq, ref_image, layer, selection)
    qualities = np.full(seq.number, np.nan)
    qualities[ref_image] = quality_estimate(ref_sel, QUALTYPE_NORMAL)
    reg[ref_image].shiftx = 0
    reg[ref_image].shifty = 0

    others = [i for i in indices if i != ref_image]
    if others:
        sels = np.stack([_selection_bottom_up(seq, i, layer, selection)
                         for i in others])
        sx, sy = register_shift_frames(ref_sel, sels, chunk=chunk,
                                       device=device)
        for k, i in enumerate(others):
            reg[i].shiftx = int(sx[k])
            reg[i].shifty = int(sy[k])
            qualities[i] = quality_estimate(sels[k], QUALTYPE_NORMAL)

    nq = normalize_quality(qualities[indices])
    for k, i in enumerate(indices):
        reg[i].quality = float(nq[k])
    best = indices[int(np.nanargmax(qualities[indices]))]
    seq.needs_saving = True
    return RegistrationReport(best_frame=best)


def register_ecc(seq, layer: int, *, process_all_frames: bool = True
                 ) -> RegistrationReport:
    """ECC translation registration over full frames
    (``register_ecc``, registration.c:786-930): not ported yet."""
    raise NotImplementedError(
        "register_ecc is not ported to siriltpu_torch yet: it needs "
        "ops/ecc.py and ops/interp.py (ROADMAP.md Queue 1 item 8)")


__all__ = ["register_shift_dft", "register_ecc", "RegistrationReport"]
