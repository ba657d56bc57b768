"""Sharded pipelines: register + stack over a device mesh.

Port of ``siriltpu.parallel.sharded``, the distributed analog of the
reference's OpenMP fan-outs (SURVEY §2.9):

- ``make_sharded_sum_stack``: each mesh entry accumulates its frame shard
  in exact integers (streaming, P6) and the partials are summed: in the
  process, then with one ``all_reduce`` across processes (JAX's ``psum``);
- ``make_sharded_register_stack``: registration (FFT phase correlation on
  the selection) runs frame-sharded; the shifts are gathered, and every
  entry aligns and rejection-stacks a ROW SLAB over ALL frames (the
  reference's block table, stacking.c:1406, at mesh scale);
- ``make_rows_sigma_stack``: the row-slab stack alone, on frames already
  aligned; the rows axis needs no collective.

The rejection of both stacks goes through
``pipelines.register_stack.stack_rejected``, which runs
``ops.cuda.reject_stack.reject_stack`` for every rejection with a
kernel: on a card the hand-written kernel of ``csrc/``
(``reject_sigma.cu`` for the default sigma), on the CPU its plain
version. Rejection is per pixel and the sums are exact, so
no partition changes a bit: sharded == unsharded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from siriltpu_torch.ops.fftreg import _ref_fft, phase_correlate
from siriltpu_torch.ops.shift import shift2d
from siriltpu_torch.parallel.mesh import Mesh, _rank, pad_frames_to_mesh
from siriltpu_torch.parallel.multihost import comm_device, spans_group
from siriltpu_torch.pipelines.register_stack import (register_and_stack,
                                                     stack_rejected)
from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_i32
from siriltpu_torch.utils.rounding import np_round_to_word


def _to(frames, device) -> torch.Tensor:
    """A uint16 array or tensor as a tensor on ``device``."""
    if isinstance(frames, torch.Tensor):
        return frames.view(torch.int16).to(device).view(torch.uint16)
    return frames_from_numpy(np.asarray(frames), device)


def _gather_device(mesh: Mesh) -> torch.device:
    """Where the pieces of a result meet: the group's collective device
    when the mesh spans the group, else this process's first entry's."""
    if spans_group(mesh):
        return comm_device()
    return torch.device(mesh.devices[mesh.ranks == _rank()][0])


def _combine(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``part`` over the processes of ``mesh`` (int32 or int64,
    disjoint or partial sums: exact), or ``part`` itself when the mesh is
    this process's alone."""
    if not spans_group(mesh):
        return part
    import torch.distributed as dist

    t = part.to(comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


# ----------------------------------------------------------- sum stacking

def make_sharded_sum_stack(mesh: Mesh):
    """Streaming per-shard accumulate + one sum of the partials (P6 + P8).

    Returns ``run(frames (F, H, W) uint16, shifts (F, 2) or None) ->
    (uint16 (H, W), hi)``, as ``oracle.stack_sum``. Every process passes
    the whole sequence; each sums its own entries' shards."""
    entries = mesh.axis_entries("frames")
    me = _rank()

    def run(frames, shifts: Optional[np.ndarray] = None):
        f = len(frames)
        n = len(entries)
        per = pad_frames_to_mesh(f, mesh) // n
        shifts = (np.zeros((f, 2), np.int32) if shifts is None
                  else np.asarray(shifts, dtype=np.int64))
        h, w = frames.shape[1:]
        acc = None
        for j, (dev, rank) in enumerate(entries):
            if rank != me:
                continue
            # the zero frames that pad the last shard add nothing
            lo, hi = min(j * per, f), min((j + 1) * per, f)
            part = torch.zeros((h, w), dtype=torch.int64, device=dev)
            shard = _to(frames[lo:hi], dev)
            for i in range(hi - lo):
                part += shift2d(u16_to_i32(shard[i]).to(torch.int64),
                                shifts[lo + i, 0], shifts[lo + i, 1], fill=0,
                                skip_origin=True)
            acc = part if acc is None else acc + part.to(acc.device)
        if acc is None:
            acc = torch.zeros((h, w), dtype=torch.int64, device=comm_device())
        acc_h = _combine(acc, mesh).cpu().numpy()
        maxim = int(acc_h.max())
        if maxim > 65535:
            return np_round_to_word(acc_h * (65535.0 / maxim)), min(maxim, 65535)
        return acc_h.astype(np.uint16), maxim

    return run


# ------------------------------------------------- register + reject stack

def register_stack_step(sel: Tuple[int, int, int], rejection: str = "sigma",
                        sig=(3.0, 3.0)):
    """The fused register + reject-stack step on (F, H, W) uint16 frames on
    one device: ``pipelines.register_stack.register_and_stack`` without
    the quality estimate. Returns ``step(frames) -> (out (H, W) uint16,
    sx, sy)``, tensors on the frames' device."""

    def step(frames: torch.Tensor):
        out, (sx, sy), _ = register_and_stack(
            frames, sel=sel, rejection=rejection, sig=sig, with_quality=False,
            return_device=True)
        return out, sx, sy

    return step


def _align_rows(frames, sx: torch.Tensor, sy: torch.Tensor, r0: int, r1: int,
                device) -> torch.Tensor:
    """Rows [r0, r1) of every frame's zero-fill shift (the rows of
    ``align_frames_slice``'s output), (F, r1 - r0, W) uint16 on
    ``device``, from the band of source rows they read alone."""
    f, h, w = frames.shape
    sx = sx.to(device=device, dtype=torch.int64)
    sy = sy.to(device=device, dtype=torch.int64)
    lo = max(0, r0 - int(sy.max()))
    hi = min(h, r1 - int(sy.min()))
    if hi <= lo:  # every row falls outside: all zero fill
        lo, hi = 0, 1
    band = _to(frames[:, lo:hi], device).view(torch.int16)
    rows = torch.arange(r0, r1, device=device)[None, :] - sy[:, None]
    cols = torch.arange(w, device=device)[None, :] - sx[:, None]
    mask = (((rows >= 0) & (rows < h))[:, :, None]
            & ((cols >= 0) & (cols < w))[:, None, :])
    g = band[torch.arange(f, device=device)[:, None, None],
             (rows.clamp(lo, hi - 1) - lo)[:, :, None],
             cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(mask, g, 0).view(torch.uint16)


def _slab_stack(mesh: Mesh, slabs, shape, rejection: str, sig,
                rows_of) -> np.ndarray:
    """The row-slab rejection stack of an (F, H, W) sequence: slab k of
    ceil(H / len(slabs)) rows belongs to ``slabs[k]`` = (device, rank);
    each of this process's gets its rows of every frame from
    ``rows_of(r0, r1, device)`` ((F, r1 - r0, W) uint16 on ``device``) and
    stacks them there. The slabs meet on one device (across processes:
    one all_reduce of the disjoint parts). Returns (H, W) uint16 NumPy,
    the same on every process."""
    f, h, w = shape
    me = _rank()
    hs = -(-h // len(slabs))
    out = torch.zeros((h, w), dtype=torch.int32, device=_gather_device(mesh))
    for k, (dev, rank) in enumerate(slabs):
        r0, r1 = min(k * hs, h), min((k + 1) * hs, h)
        if rank != me or r0 == r1:
            continue
        # the kernel takes contiguous (F, P) values: a slice of rows is not
        rows = rows_of(r0, r1, dev).reshape(f, (r1 - r0) * w).contiguous()
        slab = stack_rejected(rows, rejection, sig)
        out[r0:r1] = u16_to_i32(slab).reshape(r1 - r0, w).to(out.device)
    out = _combine(out, mesh).cpu()
    return out.to(torch.int16).numpy().view(np.uint16)


def sharded_register_stack(mesh: Mesh, sel: Tuple[int, int, int],
                           rejection: str, sig, frames):
    """The sharded register + stack of the whole (F, H, W) uint16
    sequence, which every process passes (an array or a tensor on any
    device). F must divide by the mesh's ``frames`` size.

    1. each ``frames`` entry of this process phase-correlates its
       contiguous frame shard against frame 0's selection on its device;
    2. the (F,) shifts are gathered (across processes: one all_reduce of
       the disjoint parts);
    3. the flat mesh entries own row slabs of ceil(H / n) rows: each of
       this process's aligns its rows of every frame and stacks them;
    4. the slabs are gathered the same way.
    Returns (out (H, W) uint16, shifts (F, 2) int32 columns (sx, sy)),
    NumPy, the same on every process."""
    f, h, w = frames.shape
    entries = mesh.axis_entries("frames")
    n = len(entries)
    if f % n:
        raise ValueError(f"{f} frames not divisible by the {n}-way frames "
                         f"mesh; pad or filter the sequence to a multiple")
    me = _rank()
    per = f // n
    x0, y0, s = sel
    if x0 < 0 or y0 < 0 or x0 + s > w or y0 + s > h:
        raise ValueError(f"selection {sel} does not fit {h}x{w} frames")
    ref = None
    shifts = torch.zeros((f, 2), dtype=torch.int64)
    for j, (dev, rank) in enumerate(entries):
        if rank != me:
            continue
        if ref is None or ref.device != torch.device(dev):
            ref = _ref_fft(_to(frames[0, y0:y0 + s, x0:x0 + s], dev))
        sels = _to(frames[j * per:(j + 1) * per, y0:y0 + s, x0:x0 + s], dev)
        sx, sy = phase_correlate(ref, sels)
        shifts[j * per:(j + 1) * per, 0] = sx.cpu()
        shifts[j * per:(j + 1) * per, 1] = sy.cpu()
    shifts = _combine(shifts, mesh).cpu()

    slabs = [(torch.device(d), int(r)) for d, r in zip(mesh.devices.flat,
                                                     mesh.ranks.flat)]
    out = _slab_stack(mesh, slabs, frames.shape, rejection, sig,
                      lambda r0, r1, dev: _align_rows(frames, shifts[:, 0],
                                                      shifts[:, 1], r0, r1, dev))
    return out, shifts.numpy().astype(np.int32)


def make_sharded_register_stack(mesh: Mesh, sel: Tuple[int, int, int],
                                rejection: str = "sigma", sig=(3.0, 3.0)):
    """The fused register + stack with frames sharded for registration and
    rows sharded for the stack. Returns ``run(frames) -> (out (H, W)
    uint16, shifts (F, 2) int32)``, NumPy; ``frames`` is an (F, H, W)
    uint16 array or tensor."""

    def run(frames):
        return sharded_register_stack(mesh, sel, rejection, sig, frames)

    return run


# --------------------------------------------- row-slab rejection stacking

def make_rows_sigma_stack(mesh: Mesh, rejection: str = "sigma", sig=(3.0, 3.0)):
    """The reference's P3 pattern (OpenMP over row blocks, stacking.c
    block table :1406) at mesh scale: every entry along the ``rows`` axis
    (the mesh's first axis if it has none) owns a ROW SLAB over ALL
    frames and rejection-stacks it on its device. Rejection is per pixel,
    so the rows axis needs no collective. Slabs are ceil(H / n) rows and
    the last takes what is left (JAX pads the rows to a multiple of n and
    cuts the pad away: per pixel, the same result).

    Returns ``run(aligned (F, H, W) uint16) -> (H, W) uint16`` NumPy."""
    axis = "rows" if "rows" in mesh.shape else mesh.axis_names[0]
    slabs = mesh.axis_entries(axis)

    def run(aligned):
        return _slab_stack(mesh, slabs, aligned.shape, rejection, sig,
                           lambda r0, r1, dev: _to(aligned[:, r0:r1], dev))

    return run


__all__ = ["make_sharded_sum_stack", "make_sharded_register_stack",
           "make_rows_sigma_stack", "register_stack_step",
           "sharded_register_stack"]
