"""Stacking of in-memory frames: method dispatch,
normalization, and the row-block loop over the device.

Port of ``siriltpu.stacking.api`` (``stack_frames`` and what it calls).
Reference: src/stacking/stacking.c —
- normalization coefficients from IKSS stats (:79-190);
- the mean-with-rejection main loop (:1189-1858), with the y-shift folded
  into the block read (:1546-1590) and the x-shift at gather time
  (:1624-1632);
- the median stack (:362-816) — NOTE: the reference median stack applies
  NO registration shifts (it is for calibration frames).

Every row block is gathered, normalized, shifted, converted exactly to
uint16 and stacked on the device: the mean and median stacks through the
CUDA rejection kernels (``ops.cuda.reject_stack``), rejection "none"
through plain PyTorch. The result crosses to the host once, at the end.

Not ported yet (ROADMAP.md Queue 1 item 7): ``filter_indices``,
``sequence_normalization``, ``stack_sequence`` and the streaming stack,
which need ``io/sequence.py``; linearfit, which needs ``verify/oracle.py``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from siriltpu_torch.core.frame import ImStats
from siriltpu_torch.ops import stack as basic_stack
from siriltpu_torch.ops.cuda.reject_stack import reject_stack
from siriltpu_torch.ops.rejection import reject_and_mean
from siriltpu_torch.ops.stats import ikss_from_histogram
from siriltpu_torch.utils.interop import (frames_from_numpy, i32_to_u16,
                                          u16_to_i32, u16_to_numpy)
from siriltpu_torch.utils.rounding import round_to_word_f

NORM_MODES = ("none", "additive", "additive_scaling", "multiplicative",
              "multiplicative_scaling")
REJECTION_MODES = ("none", "percentile", "sigma", "sigmedian", "winsorized",
                   "linearfit")
METHODS = ("sum", "mean", "median", "max", "min")


# ------------------------------------------------------------- normalization

def compute_normalization(stats: Seq[ImStats], ref_index: int, mode: str):
    """Per-frame (offset, mul, scale) from IKSS location/scale
    (``_compute_normalization_for_image``, stacking.c:79-123)."""
    n = len(stats)
    offset = np.zeros(n)
    mul = np.ones(n)
    scale = np.ones(n)
    if mode == "none":
        return offset, mul, scale
    if mode not in NORM_MODES:
        raise ValueError(f"unknown normalization {mode}")
    ref = stats[ref_index]
    scale0, loc0 = ref.scale, ref.location
    for i, st in enumerate(stats):
        if mode.endswith("_scaling"):
            scale[i] = scale0 / st.scale if st.scale != 0 else 1.0
        if mode.startswith("additive"):
            offset[i] = scale[i] * st.location - loc0
        else:
            mul[i] = loc0 / st.location if st.location != 0 else 1.0
    return offset, mul, scale


def ikss_stats(frames: torch.Tensor, batch: int = 64) -> list:
    """IKSS location and scale of layer 0 of every (C, H, W) frame, as
    ``ops.stats.statistics(frame, 0, option=STATS_EXTRA)`` gives them:
    the value histograms are counted on the frames' device, and the IKSS
    iteration runs on the host, in float64, one thread per frame."""
    f, _, h, w = frames.shape
    counts = []
    for a in range(0, f, batch):
        layer = u16_to_i32(frames[a:a + batch, 0]).reshape(-1, h * w).to(torch.int64)
        # frame i's values count in bins [i * 65536, (i + 1) * 65536)
        offs = torch.arange(layer.shape[0], device=frames.device)[:, None] << 16
        counts.append(torch.bincount((layer + offs).reshape(-1),
                                     minlength=layer.shape[0] << 16)
                      .reshape(-1, 65536).cpu().numpy())
    counts = np.concatenate(counts)

    def one(c):
        # statistics(): values up to 255 are 8-bit data, normalized by 255
        norm = 255 if not c[256:].any() else 65535
        loc, scale = ikss_from_histogram(c[: norm + 1], float(norm))
        return ImStats(location=loc, scale=scale, norm_value=float(norm))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, counts))


# ----------------------------------------------------------- block assembly

def _normalize_block(block: torch.Tensor, coeffs: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Apply per-frame normalization (stacking.c:1635-1651).
    block (F, Bh, W) uint16 -> float32 normalized WORD values, rounded in
    the JAX package's float32 order of operations."""
    x = u16_to_i32(block).to(torch.float32)
    if mode == "none":
        return x
    scale = coeffs[:, 2][:, None, None]
    if mode.startswith("additive"):
        offset = coeffs[:, 0][:, None, None]
        return round_to_word_f(x * scale - offset)
    mul = coeffs[:, 1][:, None, None]
    return round_to_word_f(x * scale * mul)


def _xshift_block(norm_vals: torch.Tensor, shiftx: torch.Tensor) -> torch.Tensor:
    """x-shift at gather time with zero fill (stacking.c:1624-1632):
    out[f, y, x] = norm_vals[f, y, x - sx] if in bounds else 0."""
    f, bh, w = norm_vals.shape
    cols = torch.arange(w, device=norm_vals.device)[None, :] - shiftx[:, None]
    inside = (cols >= 0) & (cols < w)
    g = torch.gather(norm_vals, 2,
                     cols.clamp(0, w - 1)[:, None, :].expand(f, bh, w))
    return torch.where(inside[:, None, :], g, 0.0)


def _gather_block_rows(frames: torch.Tensor, ch: int, r0: int, r1: int,
                       shifts_y: torch.Tensor) -> torch.Tensor:
    """y-shifted block gather with zero fill (stacking.c:1546-1590): block
    row y (bottom-up) of frame i comes from frame row y - shifty[i].
    (F, r1 - r0, W) uint16."""
    f, _, h, _ = frames.shape
    dev = frames.device
    rows = torch.arange(r0, r1, device=dev)[None, :] - shifts_y[:, None]
    inside = (rows >= 0) & (rows < h)
    g = frames[:, ch].view(torch.int16)[torch.arange(f, device=dev)[:, None],
                                        rows.clamp(0, h - 1)]
    return torch.where(inside[:, :, None], g, 0).view(torch.uint16)


def _to_u16(x: torch.Tensor) -> torch.Tensor:
    """WORD-valued float32 -> uint16, exactly (clip, then cast)."""
    return i32_to_u16(x.clamp(0, 65535).to(torch.int32))


def default_block_rows(f: int, w: int, *, budget_bytes: int = 1 << 28) -> int:
    """Rows per block so the f32 working set fits the budget (the
    reference's memory_percent formula analog, stacking.c:1903-1915)."""
    per_row = f * w * 4 * 3  # values + sort buffer + mask, f32-ish
    rows = max(1, budget_bytes // per_row)
    return int(rows)


# ---------------------------------------------------------------- entry points

@dataclass
class StackResult:
    data: np.ndarray            # (C, H, W) uint16
    rejection_low: np.ndarray   # per channel total low-rejected pixels
    rejection_high: np.ndarray
    total_pixels: int = 0

    def rejection_percent(self, channel: int) -> Tuple[float, float]:
        """Per-channel rejection percentages (stacking.c:1811-1817)."""
        npix = self.total_pixels
        if not npix:
            return 0.0, 0.0
        return (100.0 * self.rejection_low[channel] / npix,
                100.0 * self.rejection_high[channel] / npix)


_COMBINATION_NAMES = {"mean": "average", "sum": "normalized sum",
                      "median": "median", "min": "minimum", "max": "maximum"}
_NORM_NAMES = {"none": "none", "additive": "additive",
               "multiplicative": "multiplicative",
               "additive_scaling": "additive + scaling",
               "multiplicative_scaling": "multiplicative + scaling"}
_REJECTION_NAMES = {"none": "none", "percentile": "percentile clipping",
                    "sigma": "sigma clipping",
                    "sigma_masked": "sigma clipping",
                    "sigmedian": "median sigma clipping",
                    "winsorized": "Winsorized sigma clipping",
                    "linearfit": "linear fit clipping"}


def stack_summary(nb_images: int, method: str, rejection: str,
                  sig=(3.0, 3.0), normalize: str = "none") -> list:
    """The consolidated pre-stack report, line for line the reference's
    _show_summary (stacking.c:1929-2011): combination method,
    normalization, rejection algorithm and parameters. Normalization and
    rejection only apply to mean-with-rejection stacks; every other
    method reports them as 'none' like the reference does."""
    lines = [f"Integration of {nb_images} images:"]
    comb = _COMBINATION_NAMES.get(method, "none")
    lines.append(f"Pixel combination ......... {comb}")
    is_mean = method == "mean"
    norm = _NORM_NAMES.get(normalize, "none") if is_mean else "none"
    lines.append(f"Normalization ............. {norm}")
    if is_mean:
        rej = _REJECTION_NAMES.get(rejection, "none")
        lines.append(f"Pixel rejection ........... {rej}")
        # the reference prints the sig parameters for every mean stack,
        # even with rejection 'none' (stacking.c:2005-2010)
        lines.append("Rejection parameters ...... "
                     f"low={sig[0]:.3f} high={sig[1]:.3f}")
    else:
        lines.append("Pixel rejection ........... none")
        lines.append("Rejection parameters ...... none")
    return lines


def stack_frames(frames, *, device, method: str = "mean",
                 shifts: Optional[np.ndarray] = None,
                 rejection: str = "sigma", sig: Tuple[float, float] = (3.0, 3.0),
                 normalize: str = "none",
                 coeffs: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                 block_rows: Optional[int] = None) -> StackResult:
    """Stack an in-memory (F, C, H, W) uint16 array (NumPy or a tensor) on
    ``device``.

    ``method``: sum | mean | median | max | min. ``mean`` applies the
    rejection algorithm; ``median`` ignores shifts (reference behavior).
    ``shifts`` is (F, 2) int (shiftx, shifty). The result does not depend
    on ``block_rows``. Returns NumPy arrays, as ``siriltpu`` does.
    """
    device = torch.device(device)
    if isinstance(frames, torch.Tensor):
        frames = frames.to(device)
    else:
        frames = frames_from_numpy(np.asarray(frames), device)
    if frames.dtype != torch.uint16 or frames.dim() != 4:
        raise ValueError(f"expected (F, C, H, W) uint16 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    f, c, h, w = frames.shape
    shifts = (np.zeros((f, 2), dtype=np.int32) if shifts is None
              else np.asarray(shifts, dtype=np.int32))
    total = f * c * h * w

    if method in ("sum", "max", "min"):
        if method == "sum":
            out, _ = basic_stack.stack_sum(frames, shifts)
        else:
            out = getattr(basic_stack, f"stack_{method}")(frames, shifts)
        return StackResult(u16_to_numpy(out), np.zeros(c), np.zeros(c), total)
    if method not in ("mean", "median"):
        raise ValueError(f"unknown method {method}")
    if method == "mean":
        if rejection not in REJECTION_MODES:
            raise ValueError(f"unknown rejection {rejection}")
        if rejection == "linearfit":
            raise NotImplementedError(
                "stack_frames with rejection 'linearfit' is not ported to "
                "siriltpu_torch yet (ROADMAP.md Queue 1 item 2)")

    if coeffs is None:
        if normalize != "none":
            off, mul, scale = compute_normalization(ikss_stats(frames), 0,
                                                    normalize)
        else:
            off, mul, scale = np.zeros(f), np.ones(f), np.ones(f)
    else:
        off, mul, scale = coeffs
    coeff_t = torch.tensor(np.stack([off, mul, scale], axis=1),
                           dtype=torch.float32, device=device)

    if block_rows is None:
        block_rows = default_block_rows(f, w)
    out = torch.empty((c, h, w), dtype=torch.int16, device=device)
    rejl = torch.zeros(c, dtype=torch.int64, device=device)
    rejh = torch.zeros(c, dtype=torch.int64, device=device)
    sx = torch.from_numpy(shifts[:, 0].astype(np.int64)).to(device)
    # the median stack applies no shifts (reference behavior)
    sy = torch.from_numpy((shifts[:, 1] if method == "mean"
                           else np.zeros(f)).astype(np.int64)).to(device)
    siglow, sighigh = float(sig[0]), float(sig[1])

    for ch in range(c):
        for r0 in range(0, h, block_rows):
            r1 = min(r0 + block_rows, h)
            block = _normalize_block(_gather_block_rows(frames, ch, r0, r1, sy),
                                     coeff_t, normalize)
            if method == "median":
                flat = _to_u16(block.reshape(f, -1))
                o = reject_stack(flat, "median", 0.0, 0.0)
            else:
                flat = _to_u16(_xshift_block(block, sx).reshape(f, -1))
                if rejection == "none":
                    o, rl, rh = reject_and_mean(flat, "none")
                else:
                    o, rl, rh = reject_stack(flat, rejection, siglow, sighigh,
                                             with_counters=True)
                rejl[ch] += rl.sum()
                rejh[ch] += rh.sum()
            out[ch, r0:r1] = o.view(torch.int16).reshape(r1 - r0, w)
    return StackResult(u16_to_numpy(out.view(torch.uint16)),
                       rejl.cpu().numpy(), rejh.cpu().numpy(), total)


__all__ = ["stack_frames", "stack_summary", "compute_normalization",
           "ikss_stats", "StackResult", "NORM_MODES", "REJECTION_MODES",
           "METHODS", "default_block_rows"]
