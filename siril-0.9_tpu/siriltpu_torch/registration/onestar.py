"""One-star (PSF-tracking) registration and the seqpsf engine.

Port of ``siriltpu.registration.onestar``: the boxes are read and their
background measured on the host, the PSF fits run on ``device``.

Reference: ``seqpsf`` (src/io/sequence.c:1627-1820) driven through the
generic sequence worker, and ``register_shift_fwhm``
(src/registration/registration.c:406-490).

Per frame: PSF-fit the selection box (optionally re-centering the box on
the found star for FOLLOW_STAR framing, sequence.c:1657-1660); star
position in top-down coordinates is xpos = x0 + area.x,
ypos = area.y + area.h − y0 (sequence.c:1652-1653; the fit box rows are
bottom-up so y flips). Shifts:
``shiftx = round(ref_x − x)``, ``shifty = round(y − ref_y)``
(registration.c:468-471 — the y sign flips because positions are
top-down while the stacking consumer works bottom-up). Quality = FWHM;
the best frame has the smallest FWHM.

Photometry is attached per frame when ``for_registration`` is False
(light-curve mode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from siriltpu_torch.core.frame import Rect, select_area
from siriltpu_torch.ops.photometry import PhotConfig, Photometry, get_photometry
from siriltpu_torch.ops.psf import fit_psf_batch, fit_psf_single
from siriltpu_torch.ops.stats import STATS_BASIC, statistics
from siriltpu_torch.utils.rounding import np_round_to_int


@dataclass
class SeqPsfResult:
    image_index: int
    xpos: float = 0.0
    ypos: float = 0.0
    fwhmx: float = 0.0
    fwhmy: float = 0.0
    mag: float = 0.0
    rmse: float = 0.0
    exposure: float = 0.0
    ok: bool = False
    photometry: Optional[Photometry] = None


def seqpsf(seq, layer: int, area: Rect, *, device,
           for_registration: bool = True, follow_star: bool = False,
           phot_config: Optional[PhotConfig] = None) -> List[SeqPsfResult]:
    """Run the PSF fit over the selection on every included frame, the
    fits on ``device``.

    With a fixed box (no FOLLOW_STAR) every frame's fit is independent,
    so all boxes go to the device as ONE batched LM fit with one result
    fetch. FOLLOW_STAR re-centers the box on the previous result
    (sequence.c:1657-1660), a genuine serial dependency, and keeps the
    per-frame loop."""
    if not follow_star:
        return _seqpsf_batched(seq, layer, area, device=device,
                               for_registration=for_registration,
                               phot_config=phot_config)
    results: List[SeqPsfResult] = []
    cur = Rect(area.x, area.y, area.w, area.h)
    for i in range(seq.number):
        res = SeqPsfResult(image_index=i)
        if not seq.imgparam[i].incl:
            results.append(res)
            continue
        frame = seq.read_frame(i)
        # clamp the box inside the frame (FOLLOW_STAR may push it out)
        x = min(max(cur.x, 0), frame.rx - cur.w)
        y = min(max(cur.y, 0), frame.ry - cur.h)
        box_rect = Rect(x, y, cur.w, cur.h)
        z = select_area(frame.layer(layer), box_rect)  # bottom-up rows
        st = statistics(z, option=STATS_BASIC, nullcheck=True)
        bg = st.median if st else 0.0
        norm = 255.0 if int(frame.data.max()) <= 255 else 65535.0
        fit = fit_psf_single(z, bg, device=device, fit_angle=True, norm=norm)
        if fit is not None:
            res.ok = True
            res.xpos = fit["x0"] + box_rect.x
            res.ypos = box_rect.y + box_rect.h - fit["y0"]
            res.fwhmx = fit["fwhmx"]
            res.fwhmy = fit["fwhmy"]
            res.mag = fit["mag"]
            res.rmse = fit["rmse"]
            res.exposure = frame.exposure
            cur = Rect(int(np_round_to_int(res.xpos)) - area.w // 2,
                       int(np_round_to_int(res.ypos)) - area.h // 2,
                       area.w, area.h)
            if not for_registration:
                res.photometry = get_photometry(
                    np.asarray(z, np.float64), fit["x0"], fit["y0"],
                    fit["sx"], phot_config)
        results.append(res)
    return results


def _seqpsf_batched(seq, layer: int, area: Rect, *, device,
                    for_registration: bool,
                    phot_config: Optional[PhotConfig]) -> List[SeqPsfResult]:
    """Fixed-box seqpsf: gather every frame's box, one batched LM fit.
    Identical per-frame math to fit_psf_single (the same batched code)."""
    results = [SeqPsfResult(image_index=i) for i in range(seq.number)]
    entries = []   # (frame_idx, z, norm, exposure)
    bgs = []
    for i in range(seq.number):
        if not seq.imgparam[i].incl:
            continue
        frame = seq.read_frame(i)
        x = min(max(area.x, 0), frame.rx - area.w)
        y = min(max(area.y, 0), frame.ry - area.h)
        box_rect = Rect(x, y, area.w, area.h)
        z = select_area(frame.layer(layer), box_rect)
        st = statistics(z, option=STATS_BASIC, nullcheck=True)
        bgs.append(st.median if st else 0.0)
        norm = 255.0 if int(frame.data.max()) <= 255 else 65535.0
        entries.append((i, z, box_rect, norm, frame.exposure))
    if not entries or entries[0][1].size <= 7:
        return results

    boxes = np.stack([e[1] for e in entries]).astype(np.float32)
    fit = fit_psf_batch(torch.from_numpy(boxes).to(device),
                        torch.tensor(bgs, dtype=torch.float32, device=device),
                        fit_angle=True, norm=1.0)
    packed = torch.stack([
        fit.B, fit.A, fit.x0, fit.y0, fit.sx, fit.sy, fit.fwhmx, fit.fwhmy,
        fit.rmse, fit.mag, fit.ok.to(torch.float32)]).cpu().numpy()
    B, A, x0, y0, sx, sy, fwx, fwy, rmse, mag, okv = packed
    for j, (i, z, box_rect, norm, expo) in enumerate(entries):
        if okv[j] == 0.0:
            continue
        res = results[i]
        res.ok = True
        res.xpos = float(x0[j]) + box_rect.x
        res.ypos = box_rect.y + box_rect.h - float(y0[j])
        res.fwhmx = float(fwx[j])
        res.fwhmy = float(fwy[j])
        # B/A/rmse are norm-relative (psf_global_minimisation :647-650);
        # the batch ran with norm=1, divide per frame in f32 like the fit
        res.mag = float(mag[j])
        res.rmse = float(np.float32(rmse[j]) / np.float32(norm))
        res.exposure = expo
        if not for_registration:
            res.photometry = get_photometry(
                np.asarray(z, np.float64), float(x0[j]), float(y0[j]),
                float(sx[j]), phot_config)
    return results


def register_onestar(seq, layer: int, area: Rect, *, device,
                     follow_star: bool = False):
    """One-star registration (``register_shift_fwhm``), the PSF fits on
    ``device``. Returns (index of the frame with the smallest FWHM, that
    FWHM, the per-frame ``SeqPsfResult`` list)."""
    reg = seq.ensure_regparam(layer)
    res = seqpsf(seq, layer, area, device=device, for_registration=True,
                 follow_star=follow_star)
    ref_image = seq.reference_image if seq.reference_image >= 0 else 0
    if not res[ref_image].ok:
        raise ValueError(
            "Registration PSF: failed to compute PSF for reference frame")
    rx, ry = res[ref_image].xpos, res[ref_image].ypos
    fwhm_min = res[ref_image].fwhmx
    fwhm_index = ref_image
    for i, r in enumerate(res):
        reg[i].fwhm = r.fwhmx if r.ok else 0.0
        if i == ref_image or not r.ok:
            reg[i].shiftx = 0
            reg[i].shifty = 0
            continue
        if 0.0 < r.fwhmx < fwhm_min:
            fwhm_min = r.fwhmx
            fwhm_index = i
        reg[i].shiftx = int(np_round_to_int(rx - r.xpos))
        reg[i].shifty = int(np_round_to_int(r.ypos - ry))
    seq.needs_saving = True
    return fwhm_index, fwhm_min, res


__all__ = ["seqpsf", "register_onestar", "SeqPsfResult"]
