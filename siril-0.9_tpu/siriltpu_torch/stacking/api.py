"""High-level stacking entry points: method dispatch, frame filtering,
normalization, and the row-block loop over the device, on frames in memory
or streamed from a sequence on disk.

Port of ``siriltpu.stacking.api``. Reference: src/stacking/stacking.c —
- ``struct stacking_args`` (stacking.h:38-56): method × rejection ×
  normalization × filtering × memory budget;
- normalization coefficients from cached IKSS stats (:79-190);
- block partitioning by memory budget (:1397-1476);
- the mean-with-rejection main loop (:1189-1858), with the y-shift folded
  into the block read (:1546-1590) and the x-shift at gather time
  (:1624-1632);
- the median stack (:362-816) — NOTE: the reference median stack applies
  NO registration shifts (it is for calibration frames);
- frame filters (:2183-2260).

Every row block is normalized, shifted, converted exactly to uint16 and
stacked on the device (``_BlockLoop``, the one block loop of both
entry points): the mean and median stacks through ``ops.cuda.reject_stack``
(the CUDA rejection kernels, or plain PyTorch for a rejection without
one), linearfit through its hybrid. The result crosses to the host once,
at the end; linearfit also brings the raw values of its knife-edge pixels
to the host, block by block, for their float64 normalization, and settles
them on the device (``_BlockLoop._linearfit``, through
``linearfit_hybrid``). ``stack_frames`` gathers its
y-shifted blocks from frames on the device; the streaming
``stack_sequence`` reads them from the files with a host thread, into
pinned memory, one block ahead of the card.

With tracing on (``utils.timing``) ``stack_sequence`` and ``stack_frames``
are spans over ``stack.normalize``, ``stack.read`` (the frames read
whole), ``stack.read_block`` (the reader thread), ``stack.wait`` (the main
thread waiting for it), ``stack.block`` (a row block's work),
``stack.linearfit_fixup`` and ``result.to_host``; the counters
``stack.blocks`` (blocks streamed) and ``linearfit.knife`` are always on.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from siriltpu_torch.core.frame import ImStats, Rect
from siriltpu_torch.core.memory import (get_available_memory_mb,
                                        get_device_memory_bytes,
                                        stacking_block_rows)
from siriltpu_torch.ops import stack as basic_stack
from siriltpu_torch.ops.cuda.reject_stack import linearfit_hybrid, reject_stack
from siriltpu_torch.ops.stats import (STATS_EXTRA, ikss_from_histogram,
                                      statistics)
from siriltpu_torch.utils.interop import (frames_from_numpy, i32_to_u16,
                                          u16_to_i32, u16_to_numpy)
from siriltpu_torch.utils.rounding import round_to_word_f
from siriltpu_torch.utils.timing import count, current, span
from siriltpu_torch.verify.oracle import normalize_pixel_vector

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


def _host_threads() -> int:
    return min(8, os.cpu_count() or 1)


def sequence_normalization(seq, layer: int, indices: Seq[int], mode: str):
    """Normalization for a Sequence using (and filling) the stats cache,
    like compute_normalization + seq_get_imstats (stacking.c:125-190). The
    frames without cached stats are read and measured on the host
    (``ops.stats.statistics``, float64 NumPy), a thread a frame."""
    if mode == "none":
        n = len(indices)
        return np.zeros(n), np.ones(n), np.ones(n)

    def compute(fr):
        return statistics(fr, layer, option=STATS_EXTRA)

    with span("stack.normalize", mode=mode):
        missing = [i for i in indices if seq.imgparam[i].stats is None]
        if missing:
            # the first read, alone, settles the sequence's lazily opened
            # state
            seq.get_imstats(missing[0], layer, compute=compute)
            with ThreadPoolExecutor(max_workers=_host_threads()) as pool:
                list(pool.map(
                    lambda i: seq.get_imstats(i, layer, compute=compute),
                    missing[1:]))
        stats = [seq.imgparam[i].stats for i in indices]
        ref = seq.reference_image if seq.reference_image >= 0 else 0
        ref_pos = indices.index(ref) if ref in indices else 0
        return compute_normalization(stats, ref_pos, mode)


# ----------------------------------------------------------------- filtering

def filter_indices(seq, *, filter_type: str = "all", param: float = 0.0,
                   layer: int = 0) -> List[int]:
    """Frame filtering criteria (stack_filter_*, stacking.c:2183-2260):
    all | included | best_fwhm (param = %) | best_quality (param = %)."""
    if filter_type == "all":
        return list(range(seq.number))
    if filter_type == "included":
        return seq.included_indices()
    reg = seq.regparam.get(layer)
    if not reg:
        raise ValueError("registration data required for best_* filtering")
    incl = np.array([bool(seq.imgparam[i].incl) for i in range(seq.number)])
    if filter_type == "best_fwhm":
        # compute_highest_accepted_fwhm (stacking.c:2248-2278): threshold is
        # val[(int)(percent*N/100)] over ALL N frames' fwhm (sorted ascending);
        # any frame with fwhm <= 0 aborts with threshold 0.0. The filter
        # itself (stack_filter_fwhm, stacking.c:2192) additionally requires
        # imgparam[i].incl and fwhm > 0.
        vals = np.array([r.fwhm for r in reg], dtype=np.float64)
        if np.any(vals <= 0.0):
            return []
        ordered = np.sort(vals)
        k = min(int(param * seq.number / 100.0), seq.number - 1)
        thresh = ordered[k]
        return [i for i in range(seq.number)
                if incl[i] and vals[i] > 0.0 and vals[i] <= thresh]
    if filter_type == "best_quality":
        # compute_highest_accepted_quality (stacking.c:2283-2309): threshold
        # is val[(int)((100-percent)*N/100)] ascending over ALL N frames;
        # an included frame with quality < 0 aborts with threshold 0.0.
        # stack_filter_quality (stacking.c:2204) requires incl and quality>0.
        vals = np.array([r.quality for r in reg], dtype=np.float64)
        if np.any(incl & (vals < 0.0)):
            return []
        ordered = np.sort(vals)
        k = min(int((100.0 - param) * seq.number / 100.0), seq.number - 1)
        thresh = ordered[k]
        return [i for i in range(seq.number)
                if incl[i] and vals[i] > 0.0 and vals[i] >= thresh]
    raise ValueError(f"unknown filter {filter_type}")


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


def _gather_block_rows_from_seq(seq, layer: int, r0: int, r1: int,
                                indices, shifts_y: np.ndarray,
                                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stream a y-shifted bottom-up row block [r0, r1) of one layer from
    every frame via partial reads (the reference's seq_opened_read_region
    + shift folding, stacking.c:1535-1591), into ``out`` where it is
    given. Memory: one block."""
    h, w = seq.ry, seq.rx
    bh = r1 - r0
    if out is None:
        out = np.empty((len(indices), bh, w), dtype=np.uint16)
    out[...] = 0
    for k, i in enumerate(indices):
        sy = int(shifts_y[k])
        # bottom-up source rows [r0-sy, r1-sy) clipped to [0, h)
        lo = max(r0 - sy, 0)
        hi = min(r1 - sy, h)
        if lo >= hi:
            continue
        # top-down area for the partial read
        area = Rect(0, h - hi, w, hi - lo)
        block_td = seq.read_frame_part(i, layer, area)
        out[k, lo - (r0 - sy) : hi - (r0 - sy)] = block_td[::-1]
    return out


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


def _check_modes(method: str, rejection: str) -> None:
    if method not in ("mean", "median"):
        raise ValueError(f"unknown method {method}")
    if method == "mean":
        if rejection not in REJECTION_MODES:
            raise ValueError(f"unknown rejection {rejection}")


class _BlockLoop:
    """The row-block loop of a mean or median stack of F frames of
    (C, H, W) on ``device``: ``stack`` takes one y-shifted (F, Bh, W)
    uint16 block there, normalizes it, applies the x-shift, converts
    exactly to uint16 and stacks it into the output rows; ``result``
    brings the image and the per-channel rejection counts to the host."""

    def __init__(self, device, shape, shifts, coeffs, *, method, rejection,
                 sig, normalize):
        _check_modes(method, rejection)
        f, c, h, w = shape
        self.device, self.total = device, f * c * h * w
        self.method, self.rejection, self.normalize = method, rejection, normalize
        self.siglow, self.sighigh = float(sig[0]), float(sig[1])
        off, mul, scale = ((np.zeros(f), np.ones(f), np.ones(f))
                           if coeffs is None else coeffs)
        self.host_coeffs = (off, mul, scale)    # f64, for the exact re-run
        self.coeffs = torch.tensor(np.stack([off, mul, scale], axis=1),
                                   dtype=torch.float32, device=device)
        self.sx = torch.from_numpy(shifts[:, 0].astype(np.int64)).to(device)
        self.out = torch.empty((c, h, w), dtype=torch.int16, device=device)
        self.rejl = torch.zeros(c, dtype=torch.int64, device=device)
        self.rejh = torch.zeros(c, dtype=torch.int64, device=device)

    def stack(self, ch: int, r0: int, r1: int, block: torch.Tensor) -> None:
        f, _, w = block.shape
        with span("stack.block", device=self.device):
            norm = _normalize_block(block, self.coeffs, self.normalize)
            if self.method == "median":
                o = reject_stack(_to_u16(norm.reshape(f, -1)), "median", 0.0, 0.0)
            elif self.rejection == "linearfit":
                o, rl, rh = self._linearfit(
                    block, _xshift_block(norm, self.sx).reshape(f, -1))
            else:
                o, rl, rh = reject_stack(
                    _to_u16(_xshift_block(norm, self.sx).reshape(f, -1)),
                    self.rejection, self.siglow, self.sighigh,
                    with_counters=True)
            if self.method == "mean":
                self.rejl[ch] += rl.sum()
                self.rejh[ch] += rh.sum()
            self.out[ch, r0:r1] = o.view(torch.int16).reshape(r1 - r0, w)

    def _linearfit(self, block: torch.Tensor, flat: torch.Tensor):
        """The linearfit HYBRID on one block (``linearfit_hybrid``): the
        f32 fit decides every pixel of ``flat``, the normalized and
        x-shifted (F, Bh * W) f32 values, and the pixels it flags as
        knife-edges are settled in float64 on the device, from their raw
        values gathered from the uint16 ``block`` at ``x - shiftx[i]``
        with zero outside and normalized on the host in float64
        (stacking.c:1635-1651). One host sync a block, and only the
        flagged pixels' (F, K) values cross, both ways. Returns (mean
        uint16, rejlow, rejhigh), each (Bh * W,)."""
        f, _, w = block.shape

        def columns(kidx):
            cols = (kidx % w)[None, :] - self.sx[:, None]
            inside = ((cols >= 0) & (cols < w)).cpu().numpy()
            raw = block.view(torch.int16)[
                torch.arange(f, device=block.device)[:, None],
                (kidx // w)[None, :], cols.clamp(0, w - 1)]
            raw = raw.cpu().numpy().view(np.uint16)
            off, mul, scale = self.host_coeffs
            vec = np.zeros(raw.shape, np.int32)
            for i in range(f):
                vec[i] = np.where(inside[i], normalize_pixel_vector(
                    raw[i], self.normalize, scale[i], off[i], mul[i]), 0)
            return torch.from_numpy(vec).to(flat.device)

        return linearfit_hybrid(flat, self.siglow, self.sighigh, columns)

    def result(self) -> StackResult:
        nbytes = 2 * self.out.numel() + 16 * self.rejl.numel()
        with span("result.to_host", device=self.device, bytes=nbytes):
            return StackResult(u16_to_numpy(self.out.view(torch.uint16)),
                               self.rejl.cpu().numpy(), self.rejh.cpu().numpy(),
                               self.total)


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
    with span("stack_frames", method=method, rejection=rejection):
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

        if method in ("sum", "max", "min"):
            if method == "sum":
                out, _ = basic_stack.stack_sum(frames, shifts)
            else:
                out = getattr(basic_stack, f"stack_{method}")(frames, shifts)
            return StackResult(u16_to_numpy(out), np.zeros(c), np.zeros(c),
                               f * c * h * w)
        _check_modes(method, rejection)
        if coeffs is None and normalize != "none":
            with span("stack.normalize", mode=normalize):
                coeffs = compute_normalization(ikss_stats(frames), 0, normalize)
        loop = _BlockLoop(device, (f, c, h, w), shifts, coeffs, method=method,
                          rejection=rejection, sig=sig, normalize=normalize)
        if block_rows is None:
            block_rows = default_block_rows(f, w)
        # the median stack applies no shifts (reference behavior)
        sy = torch.from_numpy((shifts[:, 1] if method == "mean"
                               else np.zeros(f)).astype(np.int64)).to(device)
        for ch in range(c):
            for r0 in range(0, h, block_rows):
                r1 = min(r0 + block_rows, h)
                loop.stack(ch, r0, r1, _gather_block_rows(frames, ch, r0, r1, sy))
        return loop.result()


def stack_sequence(seq, *, device, method: str = "mean", layer_shifts: int = 0,
                   filter_type: str = "included", filter_param: float = 0.0,
                   rejection: str = "sigma", sig=(3.0, 3.0),
                   normalize: str = "none",
                   block_rows: Optional[int] = None,
                   stream: Optional[bool] = None) -> StackResult:
    """Stack a Sequence on ``device``: filtering → normalization from
    cached stats → the frames read whole, or in row blocks with
    ``stream`` → device stacking. The .seq-level entry point matching
    start_stacking (stacking.c:1871-1927)."""
    with span("stack_sequence", method=method, rejection=rejection):
        device = torch.device(device)
        indices = filter_indices(seq, filter_type=filter_type, param=filter_param,
                                 layer=layer_shifts)
        if len(indices) < 2:
            raise ValueError("No frame selected for stacking (select at least 2)")
        shifts = seq.reg_shifts(layer_shifts)[indices]
        if stream is None:
            # stream when the whole sequence would not comfortably fit the
            # reference's memory budget (stacking.c:1903-1915), on the host or
            # on the device
            seq_mb = (len(indices) * max(seq.nb_layers, 1) * seq.rx * seq.ry * 2
                      / (1 << 20))
            stream = seq_mb > 0.25 * min(get_available_memory_mb(),
                                         get_device_memory_bytes(device) >> 20)
        if stream and method in ("mean", "median"):
            return _stack_sequence_streaming(
                seq, indices, shifts, device=device, method=method,
                layer_shifts=layer_shifts, rejection=rejection, sig=sig,
                normalize=normalize, block_rows=block_rows)
        with span("stack.read"):
            frames = np.stack([seq.read_frame(i).data for i in indices])
        coeffs = None
        if normalize != "none" and method in ("mean", "median"):
            coeffs = sequence_normalization(seq, layer_shifts, indices, normalize)
        return stack_frames(frames, device=device, method=method, shifts=shifts,
                            rejection=rejection, sig=sig, normalize=normalize,
                            coeffs=coeffs, block_rows=block_rows)


def _stack_sequence_streaming(seq, indices, shifts, *, device, method: str,
                              layer_shifts: int, rejection: str, sig,
                              normalize: str,
                              block_rows: Optional[int]) -> StackResult:
    """Bounded-memory stacking: row blocks are read from the files with
    the y-shift folded into the read window (the reference's streaming
    model, stacking.c:1535-1591); two (F, Bh, W) blocks live in host
    memory and on the device.

    Double-buffered: a host thread reads block i + 1 from disk into one of
    two host buffers and, on a card, queues its copy to the device on a
    side stream, while the main thread queues the work on block i. On a
    card the buffers are pinned, the copy does not block, and an event
    tells the compute stream when the block has arrived; the reader
    refills a buffer only once the work on the block it held is done."""
    _check_modes(method, rejection)
    if seq.nb_layers == -1 or seq.rx == 0:
        seq.read_frame(indices[0])  # populates nb_layers/rx/ry
    f = len(indices)
    c, h, w = seq.nb_layers, seq.ry, seq.rx
    coeffs = None
    if normalize != "none":
        coeffs = sequence_normalization(seq, layer_shifts, indices, normalize)
    if block_rows is None:
        # the host's budget and the device's
        block_rows = min(stacking_block_rows(w, f), default_block_rows(f, w))
        block_rows = min(max(block_rows, 16), h)
    loop = _BlockLoop(device, (f, c, h, w), shifts, coeffs, method=method,
                      rejection=rejection, sig=sig, normalize=normalize)
    blocks = [(ch, r0, min(r0 + block_rows, h))
              for ch in range(c) for r0 in range(0, h, block_rows)]
    sy = np.zeros(f, np.int32) if method == "median" else shifts[:, 1]
    cuda = device.type == "cuda"
    bufs = [torch.empty(f * block_rows * w, dtype=torch.int16, pin_memory=cuda)
            for _ in range(2)]
    done = [None, None]   # per buffer: the work on the block it held
    copy_stream = torch.cuda.Stream(device) if cuda else None

    caller = current()

    def load(bi):
        ch, r0, r1 = blocks[bi]
        with span("stack.read_block", parent=caller):
            if done[bi % 2] is not None:
                done[bi % 2].synchronize()
            host = bufs[bi % 2][: f * (r1 - r0) * w].view(f, r1 - r0, w)
            _gather_block_rows_from_seq(seq, ch, r0, r1, indices, sy,
                                        out=host.numpy().view(np.uint16))
            if not cuda:
                return host, None
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                dev = host.to(device, non_blocking=True)
                arrived = torch.cuda.Event()
                arrived.record(copy_stream)
            return dev, arrived

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load, 0)
        for bi, (ch, r0, r1) in enumerate(blocks):
            with span("stack.wait"):
                block, arrived = fut.result()
            if bi + 1 < len(blocks):
                fut = pool.submit(load, bi + 1)
            if cuda:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(arrived)
                block.record_stream(stream)
            loop.stack(ch, r0, r1, block.view(torch.uint16))
            if cuda:
                done[bi % 2] = torch.cuda.Event()
                done[bi % 2].record(stream)
    count("stack.blocks", len(blocks))
    return loop.result()


__all__ = ["stack_frames", "stack_sequence", "stack_summary",
           "compute_normalization", "sequence_normalization", "ikss_stats",
           "filter_indices", "StackResult", "NORM_MODES", "REJECTION_MODES",
           "METHODS", "default_block_rows"]
