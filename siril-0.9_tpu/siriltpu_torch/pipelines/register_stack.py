"""Fused register + stack pipeline — the framework's flagship workload:
register and sigma-clip stack a 100-frame 4096x4096 uint16 mono sequence
(any rejection with a kernel runs the same way).

Port of ``siriltpu.pipelines.register_stack``. Four stages over a
device-resident (F, H, W) uint16 frame batch:

1. ``compute_shifts``: one batched rfft2 phase correlation over the
   square registration selection of every frame;
2. ``quality_estimate_batch``: PIPP quality on the same selections;
3. ``align_frames_auto``: integer zero-fill shift of every frame, on the
   card one launch of the ``align_shift`` CUDA kernel;
4. ``stack_rejected``: ``reject_stack``, the rejection's CUDA kernel
   (sort + clip + mean per pixel, its degenerate pixels re-run exactly)
   or, for a rejection without one, plain PyTorch.

With tracing on (``utils.timing``) a call is a ``register_and_stack``
span over the stages' spans ``register.shifts``, ``register.quality``,
``align.copy``, ``stack.reject`` and ``result.to_host``, whatever
functions implement them (and ``align.shift_read`` before ``align.copy``
on the CPU). On the card nothing between ``register.shifts`` and
``result.to_host`` waits for the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from siriltpu_torch.ops.cuda.align_shift import align_shift
from siriltpu_torch.ops.cuda.reject_stack import reject_stack
from siriltpu_torch.ops.fftreg import _ref_fft, phase_correlate
from siriltpu_torch.ops.quality import quality_estimate_batch
from siriltpu_torch.ops.shift import shift_into
from siriltpu_torch.utils.interop import (i32_to_u16, shifts_to_numpy,
                                          u16_to_numpy)
from siriltpu_torch.utils.timing import span


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


def align_frames_slice(frames: torch.Tensor, sx: torch.Tensor,
                       sy: torch.Tensor) -> torch.Tensor:
    """Zero-fill integer shift of every frame, uint16 -> uint16:
    out[f, y, x] = frames[f, y - sy_f, x - sx_f], or 0 outside; any shift.
    The shifts are read to the host (a wait for the card there), then each
    frame is one rectangle copy into a zeroed output. The plain version of
    the ``align_shift`` kernel."""
    with span("align.shift_read"):
        xs, ys = sx.tolist(), sy.tolist()
    with span("align.copy", device=frames.device, form="slice"):
        src = frames.view(torch.int16)
        out = torch.zeros_like(src)
        for i, (x, y) in enumerate(zip(xs, ys)):
            shift_into(out[i], src[i], x, y)
    return out.view(torch.uint16)


#: ``siriltpu`` exports a gather and a slice form of its align; here both
#: names are the one plain function
align_frames_gather = align_frames_slice


def align_frames_auto(frames: torch.Tensor, sx: torch.Tensor,
                      sy: torch.Tensor) -> torch.Tensor:
    """The zero-fill shift of :func:`align_frames_slice`. On the card, the
    ``align_shift`` kernel: every frame in one launch, the shifts read on
    the device, no host sync. Elsewhere :func:`align_frames_slice`."""
    if frames.device.type == "cuda":
        with span("align.copy", device=frames.device, form="kernel"):
            return align_shift(frames.contiguous(),
                               sx.to(torch.int32).contiguous(),
                               sy.to(torch.int32).contiguous())
    return align_frames_slice(frames, sx, sy)


def stack_rejected(flat: torch.Tensor, rejection: str, sig) -> torch.Tensor:
    """(F, P) uint16 aligned values -> (P,) uint16 rejection mean."""
    return reject_stack(flat, rejection, sig[0], sig[1])


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
    ``reject_stack`` stacks every rejection: sigma, median, percentile,
    sigmedian and winsorized with their kernels; none, sigma_masked and
    linearfit in plain PyTorch (linearfit as the f32 fit, without the
    exact re-run of ``stacking.api``, as in ``siriltpu``).
    """
    f, h, w = frames_dev.shape
    dev = frames_dev.device
    with span("register_and_stack", F=f, H=h, W=w, rejection=rejection):
        with span("register.shifts", device=dev):
            sx, sy = compute_shifts(frames_dev, ref_index, sel)
        quality = None
        if with_quality:
            # the reference estimates quality on the registration SELECTION,
            # not the full frame (registration.c:264,309)
            with span("register.quality", device=dev):
                quality = quality_estimate_batch(_selection(frames_dev, sel))
        aligned = align_frames_auto(frames_dev, sx, sy)
        stacked = stack_rejected(aligned.reshape(f, h * w), rejection,
                                 sig).reshape(h, w)
        if return_device:
            return stacked, (sx, sy), quality
        return _to_host(stacked, sx, sy, quality)


def _to_host(stacked: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
             quality):
    """The stack, the (F, 2) shifts and the quality as NumPy arrays: one
    copy each of the stack, sx, sy and the quality, each a wait for the
    card there."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (stacked, sx, sy, quality) if t is not None)
    with span("result.to_host", device=stacked.device, bytes=nbytes):
        return (_stack_to_host(stacked), shifts_to_numpy(sx, sy),
                None if quality is None else quality.cpu().numpy())


def _stack_to_host(stacked: torch.Tensor) -> np.ndarray:
    """The (H, W) uint16 stack as a NumPy array. From the card it is one
    DMA copy into page-locked memory: a block of PyTorch's caching host
    allocator, which the returned array holds and which a later call
    reuses once the array is dropped. A pageable destination is a fresh
    host allocation a call, filled by the CPU through the CUDA runtime's
    staging buffers, and its time swings with the host's load: at 4096 x
    4096 on an H100 host, 15.5 ms (median; up to 27 ms) against 0.68 ms
    pinned."""
    if stacked.device.type != "cuda":
        return u16_to_numpy(stacked)
    host = torch.empty(stacked.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(stacked.view(torch.int16), non_blocking=True)
    torch.cuda.current_stream(stacked.device).synchronize()
    return host.numpy().view(np.uint16)


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
        shift_into(shifted, base, int(shifts[i, 0]), int(shifts[i, 1]))
        frames[i] = i32_to_u16(torch.clamp(shifted + noise, 0, 65535)).view(torch.int16)
    return frames.view(torch.uint16)


class RegisterStackBench:
    """The synthetic sequence of the north-star workload: ``nframes``
    frames of ``size`` x ``size`` drifting by ``shifts`` (frame 0 fixed),
    made on ``device`` from ``seed``, and the central registration
    selection ``sel`` (at most 512 pixels a side)."""

    def __init__(self, size: int = 4096, nframes: int = 100, seed: int = 0,
                 device="cuda"):
        self.size = size
        self.nframes = nframes
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


__all__ = ["register_and_stack", "compute_shifts", "align_frames_gather",
           "align_frames_slice", "align_frames_auto", "RegisterStackBench"]
