"""Translation-family registration of a sequence: DFT phase correlation
and ECC.

Port of ``siriltpu.registration.translation``. Reference:
src/registration/registration.c — ``register_shift_dft`` (:182-400) and
``register_ecc`` (:786-930). Both produce per-frame regdata {shiftx,
shifty, quality} on the chosen layer; qualities are normalized to [0, 1] afterwards (``normalizeQualityData``
:163-176). Consumers apply shifts as ``out(y, x) = frame(y - shifty, x -
shiftx)`` in bottom-up rows.

Row-order note: the reference reads FITS selections bottom-up
(``readfits_partial`` does not flip) but SER selections top-down
(``ser_read_opened_partial``), which flips the sign of the DFT shifty for
SER sequences — a latent reference bug that would misalign SER stacks.
We read ALL selections bottom-up (the self-consistent FITS convention),
so shifts always align the stack regardless of container format.

The frames are read and their quality estimated on the host, in float64
NumPy as in ``siriltpu`` (the batched float32 estimate on the device
rounds differently); the phase correlation and the ECC iteration run on
``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from siriltpu_torch.core.frame import Rect, select_area
from siriltpu_torch.ops.ecc import ecc_translation_batch
from siriltpu_torch.ops.fftreg import register_shift_frames
from siriltpu_torch.ops.quality import (QUALTYPE_NORMAL, normalize_quality,
                                        quality_estimate)
from siriltpu_torch.utils.rounding import np_round_to_int
from siriltpu_torch.utils.timing import span


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


def register_ecc(seq, layer: int, *, device,
                 process_all_frames: bool = True) -> RegistrationReport:
    """ECC translation registration over full frames
    (``register_ecc``, registration.c:786-930), the iteration on
    ``device``. Failing frames are excluded from the sequence
    (incl = False). With tracing on, its stages are the spans ``ecc.read``
    (frame reads), ``ecc.device`` (the iteration on the device with its
    copies to and from it) and ``ecc.quality`` (host quality estimates)."""
    reg = seq.ensure_regparam(layer)
    ref_image = _ref_index(seq)
    indices = [i for i in range(seq.number)
               if process_all_frames or seq.imgparam[i].incl]
    with span("ecc.read"):
        ref_layer = seq.read_frame(ref_image).layer(layer)
    qualities = np.full(seq.number, np.nan)
    with span("ecc.quality"):
        qualities[ref_image] = quality_estimate(ref_layer, QUALTYPE_NORMAL)
    failed = 0
    others = [i for i in indices if i != ref_image]
    reg[ref_image].shiftx = 0
    reg[ref_image].shifty = 0
    # every frame of a chunk aligns in one batched iteration on the device
    # (the reference parallelizes this loop with OpenMP,
    # registration.c:849); chunked so a long sequence doesn't need all
    # frames resident
    ref8 = torch.from_numpy(
        np.minimum(ref_layer, 255).astype(np.float32)).to(device)
    chunk = 64
    for c0 in range(0, len(others), chunk):
        batch = others[c0: c0 + chunk]
        with span("ecc.read"):
            layers = [seq.read_frame(i).layer(layer) for i in batch]
        with span("ecc.device", device=torch.device(device)):
            imgs8 = torch.from_numpy(
                np.minimum(np.stack(layers), 255).astype(np.float32)).to(device)
            txs, tys, rhos = (v.cpu().numpy()
                              for v in ecc_translation_batch(ref8, imgs8))
        with span("ecc.quality"):
            for k, i in enumerate(batch):
                if rhos[k] <= 0:
                    seq.set_included(i, False)
                    failed += 1
                    continue
                qualities[i] = quality_estimate(layers[k], QUALTYPE_NORMAL)
                reg[i].shiftx = int(-np_round_to_int(float(txs[k])))
                reg[i].shifty = int(-np_round_to_int(float(tys[k])))

    ok = [i for i in indices if not np.isnan(qualities[i])]
    nq = normalize_quality(qualities[ok])
    for k, i in enumerate(ok):
        reg[i].quality = float(nq[k])
    best = ok[int(np.nanargmax(qualities[ok]))]
    seq.needs_saving = True
    return RegistrationReport(best_frame=best, failed=failed)


__all__ = ["register_shift_dft", "register_ecc", "RegistrationReport"]
