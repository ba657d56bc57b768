"""Calibration (preprocessing): offset/dark/flat + dark optimization +
cosmetic correction over single frames or sequences.

Port of ``siriltpu.pipelines.preprocess``, which is NumPy already: copied
without change, on the host (the port's ``ops/imops.py``,
``ops/cosmetic.py`` and ``ops/stats.py``); the ``pp_`` SER and FITS
outputs are byte-equal to the JAX package's.

Reference: src/core/siril.c —
- ``preprocess`` (:945-961): brut −= offset; brut −= dark (unless dark
  optimization already subtracted it); brut = flat-divide with level;
- ``darkOptimization`` (:963-985): golden-section search of k in [0, 2]
  minimizing the background noise of (brut − k·dark), tolerance 1e-3
  (:922-943, noise via STATS_BASIC bgnoise summed over channels
  :886-919); then brut −= k·(dark − offset);
- ``seqpreprocess`` (:1019-1169): flat auto-level = mean of the flat's
  R layer; deviant map from the dark once; per frame: optimize,
  calibrate, cosmetic-correct, save with the ``pp_`` prefix (FITS) or
  into a new SER.

The golden-section noise evaluations run on host float64 (exact parity);
the per-evaluation cost is one vectorized FnNoise1 pass.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from siriltpu_torch.core.frame import Frame
from siriltpu_torch.ops import imops
from siriltpu_torch.ops.cosmetic import cosmetic_correction, find_deviant_pixels
from siriltpu_torch.ops.stats import STATS_BASIC, statistics

GR = (math.sqrt(5) - 1) / 2


@dataclass
class PreproConfig:
    use_offset: bool = False
    use_dark: bool = False
    use_flat: bool = False
    use_dark_optim: bool = False
    use_cosmetic: bool = False
    autolevel: bool = True
    normalisation: float = 1.0
    sigma: tuple = (3.0, 3.0)  # cosmetic detection sigmas
    is_cfa: bool = False
    prefix: str = "pp_"


def evaluate_noise_of_calibrated(brut: np.ndarray, dark: np.ndarray,
                                 k: float) -> float:
    """Noise of (brut − k·dark), first layer only like CP_EXTRACT
    (siril.c:886-919): round_to_WORD(k*dark) subtracted with imoper."""
    dark_k = imops.soper(dark[:1], k, imops.OPER_MUL)
    fit = imops.imoper(brut[:1], dark_k, imops.OPER_SUB)
    st = statistics(fit[0], option=STATS_BASIC, nullcheck=True)
    return st.bgnoise if st else 0.0


def golden_section_search(brut: np.ndarray, dark: np.ndarray,
                          a: float = 0.0, b: float = 2.0,
                          tol: float = 1e-3) -> float:
    """goldenSectionSearch (siril.c:922-943)."""
    c = b - GR * (b - a)
    d = a + GR * (b - a)
    while abs(c - d) > tol:
        fc = evaluate_noise_of_calibrated(brut, dark, c)
        fd = evaluate_noise_of_calibrated(brut, dark, d)
        if fc < fd:
            b = d
            d = c
            c = b - GR * (b - a)
        else:
            a = c
            c = d
            d = a + GR * (b - a)
    return (b + a) / 2


def dark_optimization(brut: np.ndarray, dark: np.ndarray,
                      offset: Optional[np.ndarray],
                      use_offset: bool) -> tuple:
    """darkOptimization (siril.c:963-985). Returns (calibrated, k)."""
    k = golden_section_search(brut, dark)
    dark_tmp = dark[:1]
    if use_offset and offset is not None:
        dark_tmp = imops.imoper(dark_tmp, offset[:1], imops.OPER_SUB)
    dark_k = imops.soper(dark_tmp, k, imops.OPER_MUL)
    out = brut.copy()
    out[:1] = imops.imoper(brut[:1], dark_k, imops.OPER_SUB)
    if brut.shape[0] > 1:
        for c in range(1, brut.shape[0]):
            out[c : c + 1] = imops.imoper(brut[c : c + 1], dark_k,
                                          imops.OPER_SUB)
    return out, k


def preprocess_single(brut: np.ndarray, *, offset=None, dark=None, flat=None,
                      config: PreproConfig) -> np.ndarray:
    """One-frame calibration (``preprocess``, siril.c:945-961 plus the
    optimization/cosmetic wrapping of seqpreprocess)."""
    cfg = config
    data = brut
    if cfg.use_dark_optim and cfg.use_dark and dark is not None:
        data, _ = dark_optimization(data, dark, offset, cfg.use_offset)
    if cfg.use_offset and offset is not None:
        data = imops.imoper(data, offset, imops.OPER_SUB)
    if cfg.use_dark and not cfg.use_dark_optim and dark is not None:
        data = imops.imoper(data, dark, imops.OPER_SUB)
    if cfg.use_flat and flat is not None:
        data, overflow = imops.fdiv(data, flat, cfg.normalisation)
    return data


def seq_preprocess(seq, *, offset: Optional[Frame] = None,
                   dark: Optional[Frame] = None, flat: Optional[Frame] = None,
                   config: Optional[PreproConfig] = None,
                   write_output: bool = True) -> List[Frame]:
    """Sequence calibration (``seqpreprocess``, siril.c:1019-1169):
    returns the calibrated frames; optionally writes ``pp_``-prefixed
    outputs (FITS files or SER, matching the input type)."""
    from siriltpu_torch.io import fits as fits_io
    from siriltpu_torch.io.ser import SerFile

    cfg = config or PreproConfig()
    if cfg.use_flat and flat is not None and cfg.autolevel:
        st = statistics(flat.data[0], option=STATS_BASIC, nullcheck=True)
        cfg.normalisation = st.mean if st else 1.0

    devs = None
    if cfg.use_cosmetic and cfg.use_dark and dark is not None:
        if dark.nlayers == 1:
            devs, icold, ihot = find_deviant_pixels(dark.data[0], cfg.sigma)

    new_ser = None
    if write_output and seq.seqtype == "ser":
        new_ser = SerFile.create(
            os.path.join(seq.seq_dir, f"{cfg.prefix}{seq.seqname}.ser"),
            width=seq.rx, height=seq.ry)

    out_frames: List[Frame] = []
    for i in range(seq.number):
        frame = seq.read_frame(i)
        data = preprocess_single(
            frame.data,
            offset=offset.data if offset is not None else None,
            dark=dark.data if dark is not None else None,
            flat=flat.data if flat is not None else None, config=cfg)
        if devs:
            data = data.copy()
            data[0] = cosmetic_correction(data[0], devs, cfg.is_cfa)
        result = Frame(data, dict(frame.meta))
        out_frames.append(result)
        if write_output:
            if new_ser is not None:
                new_ser.write_frame(result)
            else:
                dest = os.path.join(
                    seq.seq_dir, f"{cfg.prefix}{seq.image_filename(i)}")
                fits_io.write_fits(dest, result)
    if new_ser is not None:
        new_ser.write_and_close()
    return out_frames


__all__ = ["preprocess_single", "seq_preprocess", "dark_optimization",
           "golden_section_search", "evaluate_noise_of_calibrated",
           "PreproConfig"]
