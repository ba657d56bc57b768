"""Fused register + stack pipeline — the framework's flagship workload:
register and sigma-clip stack a 100-frame 4096x4096 uint16 mono sequence.

Port of ``siriltpu.pipelines.register_stack``. Four stages over a
device-resident (F, H, W) uint16 frame batch:

1. ``compute_shifts``: one batched rfft2 phase correlation over the
   square registration selection of every frame;
2. ``quality_estimate_batch``: PIPP quality on the same selections;
3. ``align_frames_auto``: integer zero-fill shift of every frame;
4. ``reject_stack``: the CUDA sigma kernel (sort + clip + mean per pixel)
   plus the exact re-run of its degenerate pixels.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from siriltpu_torch.ops.cuda.reject_stack import reject_stack
from siriltpu_torch.ops.fftreg import _ref_fft, phase_correlate
from siriltpu_torch.ops.quality import quality_estimate_batch
from siriltpu_torch.utils.interop import (i32_to_u16, shifts_to_numpy,
                                          u16_to_numpy)

ALIGN_MARGIN = 64  # shift bound of the slice-form align


def _selection(frames: torch.Tensor, sel: Tuple[int, int, int]) -> torch.Tensor:
    x0, y0, s = sel
    _, h, w = frames.shape
    if x0 < 0 or y0 < 0 or x0 + s > w or y0 + s > h:
        raise ValueError(f"selection {sel} does not fit {h}x{w} frames")
    return frames[:, y0 : y0 + s, x0 : x0 + s]


def compute_shifts(frames: torch.Tensor, ref_index: int,
                   sel: Tuple[int, int, int]):
    """Phase-correlation shifts of every frame against the reference frame
    over the square selection sel = (x0, y0, size) in bottom-up coords.
    Returns (sx, sy) int32 (F,)."""
    sels = _selection(frames, sel)
    sx, sy = phase_correlate(_ref_fft(sels[ref_index]), sels)
    # the reference frame has shift 0 by construction (self-correlation
    # peaks at 0), but enforce it like the reference does
    sx[ref_index] = 0
    sy[ref_index] = 0
    return sx, sy


def align_frames_gather(frames: torch.Tensor, sx: torch.Tensor,
                        sy: torch.Tensor) -> torch.Tensor:
    """Zero-fill integer shift of every frame, uint16 -> uint16:
    out[f, y, x] = frames[f, y - sy_f, x - sx_f], or 0 outside. One
    gather with clipped per-frame row and column indices; any shift."""
    f, h, w = frames.shape
    dev = frames.device
    rows = torch.arange(h, device=dev)[None, :] - sy.to(torch.int64)[:, None]
    cols = torch.arange(w, device=dev)[None, :] - sx.to(torch.int64)[:, None]
    mask = (((rows >= 0) & (rows < h))[:, :, None]
            & ((cols >= 0) & (cols < w))[:, None, :])
    g = frames.view(torch.int16)[
        torch.arange(f, device=dev)[:, None, None],
        rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(mask, g, 0).view(torch.uint16)


def _shift_into(out: torch.Tensor, src: torch.Tensor, sx: int, sy: int):
    """out[y, x] = src[y - sy, x - sx] where that lies inside src; the
    rest of ``out`` is left as it is."""
    h, w = src.shape
    y0, y1 = max(0, sy), min(h, h + sy)
    x0, x1 = max(0, sx), min(w, w + sx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = src[y0 - sy : y1 - sy, x0 - sx : x1 - sx]


def _align_slice(frames: torch.Tensor, xs, ys) -> torch.Tensor:
    out = torch.zeros_like(frames.view(torch.int16))
    src = frames.view(torch.int16)
    for i, (x, y) in enumerate(zip(xs, ys)):
        _shift_into(out[i], src[i], x, y)
    return out.view(torch.uint16)


def align_frames_slice(frames: torch.Tensor, sx: torch.Tensor,
                       sy: torch.Tensor) -> torch.Tensor:
    """The same zero-fill shift as :func:`align_frames_gather`, as one
    rectangle copy per frame into a zeroed output: a straight copy
    instead of a gather. Exact for any shift; it costs one host sync to
    read the shifts."""
    return _align_slice(frames, sx.tolist(), sy.tolist())


def align_frames_auto(frames: torch.Tensor, sx: torch.Tensor,
                      sy: torch.Tensor, margin: int = ALIGN_MARGIN
                      ) -> torch.Tensor:
    """Slice form for shifts up to ``margin``, gather form beyond it (a
    frame that has drifted that far is mostly zero fill)."""
    # host sync: the choice needs max |shift| on the host (JAX decides on
    # the device with lax.cond); the slice form reuses the shifts read here
    xs, ys = sx.tolist(), sy.tolist()
    if max(max(abs(x), abs(y)) for x, y in zip(xs, ys)) <= margin:
        return _align_slice(frames, xs, ys)
    return align_frames_gather(frames, sx, sy)


def register_and_stack(frames_dev: torch.Tensor, *, sel: Tuple[int, int, int],
                       ref_index: int = 0, rejection: str = "sigma",
                       sig=(3.0, 3.0), block_rows: int = 128,
                       with_quality: bool = True, return_device: bool = False,
                       keep_frames: bool = False):
    """Full pipeline on a device-resident (F, H, W) uint16 frame batch.

    Returns (stacked (H, W) uint16 np.ndarray, shifts (F, 2) int32,
    quality (F,) float32 or None). With ``return_device`` the results stay
    tensors on the frames' device: (stacked, (sx, sy), quality).

    ``block_rows`` and ``keep_frames`` are accepted for the signature of
    ``siriltpu``'s function and have no effect: the kernel stacks all rows
    in one launch, and eager PyTorch never donates the caller's frames.
    Only ``rejection="sigma"`` is ported.
    """
    if rejection != "sigma":
        raise NotImplementedError(
            f"register_and_stack with rejection {rejection!r} is not ported "
            "yet (ROADMAP.md Queue 2)")
    f, h, w = frames_dev.shape
    sx, sy = compute_shifts(frames_dev, ref_index, sel)
    quality = None
    if with_quality:
        # the reference estimates quality on the registration SELECTION,
        # not the full frame (registration.c:264,309)
        quality = quality_estimate_batch(_selection(frames_dev, sel))
    aligned = align_frames_auto(frames_dev, sx, sy)
    stacked = reject_stack(aligned.reshape(f, h * w), float(sig[0]),
                           float(sig[1])).reshape(h, w)
    if return_device:
        return stacked, (sx, sy), quality
    return (u16_to_numpy(stacked), shifts_to_numpy(sx, sy),
            None if quality is None else quality.cpu().numpy())


def _make_bench_frames(shifts: np.ndarray, nframes: int, size: int,
                       seed: int, device) -> torch.Tensor:
    """Generate the synthetic shifted sequence on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: a noisy sky with 200 bright
    points, shifted with zero fill by ``shifts[i] = (sx, sy)`` for frame i,
    plus fresh noise per frame. (F, size, size) uint16."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kw = dict(generator=g, device=device)
    base = 1200.0 + 60.0 * torch.randn((size, size), **kw)
    # sprinkle bright point structure so registration/quality do real work
    npts = 200
    ys = torch.randint(10, size - 10, (npts,), **kw)
    xs = torch.randint(10, size - 10, (npts,), **kw)
    amps = 5000.0 + 35000.0 * torch.rand((npts,), **kw)
    base.index_put_((ys, xs), amps, accumulate=True)
    frames = torch.empty((nframes, size, size), dtype=torch.int16, device=device)
    shifted = torch.empty_like(base)
    for i in range(nframes):
        noise = 10.0 * torch.randn((size, size), **kw)
        # ZERO-FILL shift (not circular), like a real capture drifting
        # off-frame; |shift| <= 20 keeps the border out of the central
        # registration selection, so the recovered shifts stay exact
        shifted.zero_()
        _shift_into(shifted, base, int(shifts[i, 0]), int(shifts[i, 1]))
        frames[i] = i32_to_u16(torch.clamp(shifted + noise, 0, 65535)).view(torch.int16)
    return frames.view(torch.uint16)


class RegisterStackBench:
    """Benchmark harness for the north-star metric. All data stays on
    ``device``; the timed section is the full register+stack pipeline."""

    def __init__(self, size: int = 4096, nframes: int = 100,
                 rejection: str = "sigma", with_quality: bool = True,
                 seed: int = 0, device="cuda"):
        self.size = size
        self.nframes = nframes
        self.rejection = rejection
        self.with_quality = with_quality
        self.seed = seed
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        self.shifts = rng.integers(-20, 21, size=(nframes, 2)).astype(np.int32)
        self.shifts[0] = 0
        s = min(512, size)
        self.sel = ((size - s) // 2, (size - s) // 2, s)
        self._master = None

    def frames(self) -> torch.Tensor:
        """The generated (F, size, size) uint16 sequence, made once."""
        if self._master is None:
            self._master = _make_bench_frames(self.shifts, self.nframes,
                                              self.size, self.seed, self.device)
        return self._master

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _once(self):
        return register_and_stack(
            self.frames(), sel=self.sel, rejection=self.rejection,
            with_quality=self.with_quality, return_device=True)

    def run(self, repeats: int = 1, with_drain_stats: bool = False):
        """Frames per second of the register+stack pipeline, averaged over
        ``repeats`` runs after one warm-up run that also checks that the
        recovered shifts are the negated generated ones.

        With ``with_drain_stats`` also returns the time and rate of copying
        the last stacked image to the host, and the frames per second with
        that copy included."""
        stacked, (sx, sy), _ = self._once()
        shifts = shifts_to_numpy(sx, sy)
        if not np.array_equal(shifts, -self.shifts):
            raise RuntimeError("registration failed: recovered shifts differ "
                               "from the generated ones")
        reps = max(repeats, 1)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            stacked, _, _ = self._once()
        self._sync()
        dt = (time.perf_counter() - t0) / reps
        fps = self.nframes / dt
        if not with_drain_stats:
            return fps
        td = time.perf_counter()
        result = u16_to_numpy(stacked)
        drain_s = time.perf_counter() - td
        if result.shape != (self.size, self.size):
            raise RuntimeError(f"stacked image has shape {result.shape}")
        return fps, {"drain_s": drain_s,
                     "drain_mbps": result.nbytes / drain_s / 1e6,
                     "fps_incl_drain": self.nframes / (dt + drain_s)}


__all__ = ["register_and_stack", "compute_shifts", "align_frames_gather",
           "align_frames_slice", "align_frames_auto", "RegisterStackBench",
           "ALIGN_MARGIN"]
