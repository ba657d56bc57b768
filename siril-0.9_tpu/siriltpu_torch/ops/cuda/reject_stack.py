"""Rejection stack of (F, P) uint16 pixels: the five CUDA rejection
kernels (``csrc/reject_<name>.cu``), their plain PyTorch versions, and the
exact re-run of degenerate pixels.

Port of ``siriltpu.ops.pallas.reject_stack`` (``reject_stack_pallas``):
one kernel for each branch of the Pallas body — sigma, median,
percentile, sigmedian and winsorized.

A CUDA tensor always goes to its kernel, and a failed build or launch
raises. A CPU tensor goes to the kernel's plain version. Every F runs on
the card: where a pixel's column (two for winsorized) does not fit in
shared memory at the smallest tile, the kernel works on a device-memory
scratch copy instead.
"""

from __future__ import annotations

import ctypes

import torch

from siriltpu_torch.ops.rejection import (_mean_of_survivors, masked_median,
                                          reject_percentile, reject_sigma,
                                          reject_sigma_window,
                                          reject_sigmedian, reject_winsorized,
                                          reject_winsorized_window)
from siriltpu_torch.utils.build import KERNELS

#: kernel launches per kernel since the counts were last set to 0 (read
#: by chip_smoke.py to show that a path went through its kernels)
launches = dict.fromkeys(KERNELS, 0)

#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448
_TILES = (128, 64, 32)
#: pixels a block on the device-memory scratch path
SCRATCH_TILE = 128
#: bytes of device-memory scratch one launch may use; more pixels run in
#: further launches
SCRATCH_BYTES = 1 << 30
#: uint16 slabs of F values a pixel needs: winsorized keeps a working copy
_SLABS = {"winsorized": 2}
#: rejections whose window kernel flags degenerate pixels for the exact
#: masked re-run
_FIXUP = {"sigma": reject_sigma, "winsorized": reject_winsorized}


def pick_tile(f: int, rejection: str = "sigma"):
    """Pixels per block for F frames: the largest tile whose columns fit
    in shared memory, or None when even the smallest does not — the
    kernel then runs on a device-memory scratch copy."""
    slabs = _SLABS.get(rejection, 1)
    for tile in _TILES:
        if slabs * f * tile * 2 <= SMEM_LIMIT:
            return tile
    return None


def _check(vals: torch.Tensor, rejection: str):
    if rejection not in KERNELS:
        raise ValueError(f"no rejection kernel {rejection!r} "
                         f"(one of {', '.join(KERNELS)})")
    if vals.dtype != torch.uint16:
        raise TypeError(f"expected uint16 values, got {vals.dtype}")
    if vals.dim() != 2 or vals.shape[0] < 1 or vals.shape[1] < 1:
        raise ValueError(f"expected non-empty (F, P) values, got {tuple(vals.shape)}")


def reject_plain(vals: torch.Tensor, rejection: str, siglow: float,
                 sighigh: float):
    """The plain version of a kernel, on any device: (mean uint16, degen
    int32, rejl int32, rejh int32), each (P,)."""
    _check(vals, rejection)
    p = vals.shape[1]
    if rejection in ("sigma", "winsorized"):
        window = (reject_sigma_window if rejection == "sigma"
                  else reject_winsorized_window)
        mean, rejl, rejh, degen = window(vals, siglow, sighigh)
        return mean, degen.to(torch.int32), rejl, rejh
    z = torch.zeros(p, dtype=torch.int32, device=vals.device)
    if rejection == "median":
        return masked_median(vals), z, z, z
    fn = reject_percentile if rejection == "percentile" else reject_sigmedian
    valid, v, rejl, rejh = fn(vals, siglow, sighigh)
    return _mean_of_survivors(v, valid), z, rejl, rejh


def reject_cuda(vals: torch.Tensor, rejection: str, siglow: float,
                sighigh: float):
    """Launch a CUDA rejection kernel on the current stream: (mean uint16,
    degen int32, rejl int32, rejh int32), each (P,). Asynchronous."""
    from siriltpu_torch.utils.build import library

    _check(vals, rejection)
    if vals.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("expected contiguous (F, P) values")
    f, p = vals.shape
    fn = getattr(library(), f"reject_{rejection}_u16")
    dev = vals.device
    mean = torch.empty(p, dtype=torch.int16, device=dev)
    degen, rejl, rejh = (torch.empty(p, dtype=torch.int32, device=dev)
                         for _ in range(3))
    tile = pick_tile(f, rejection)
    if tile is None:
        slabs = _SLABS.get(rejection, 1)
        chunk = max(SCRATCH_TILE, SCRATCH_BYTES // (2 * slabs * f)
                    // SCRATCH_TILE * SCRATCH_TILE)
        chunk = min(chunk, p)
        scratch = torch.empty(slabs * f * chunk, dtype=torch.int16, device=dev)
        spans = [(a, min(a + chunk, p)) for a in range(0, p, chunk)]
        tile = SCRATCH_TILE
    else:
        scratch, spans = None, [(0, p)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a, b in spans:
            rc = fn(vals.data_ptr() + 2 * a, p,
                    None if scratch is None else scratch.data_ptr(),
                    mean.data_ptr() + 2 * a, degen.data_ptr() + 4 * a,
                    rejl.data_ptr() + 4 * a, rejh.data_ptr() + 4 * a,
                    f, b - a, tile, ctypes.c_float(siglow),
                    ctypes.c_float(sighigh), stream)
            if rc != 0:
                raise RuntimeError(f"reject_{rejection}_u16 launch failed: "
                                   f"cudaError_t {rc}")
            launches[rejection] += 1
    return mean.view(torch.uint16), degen, rejl, rejh


def fix_degenerate(vals: torch.Tensor, rejection: str, mean: torch.Tensor,
                   degen: torch.Tensor, rejl: torch.Tensor, rejh: torch.Tensor,
                   siglow: float, sighigh: float):
    """Re-run every degenerate pixel through the exact masked
    ``reject_sigma`` or ``reject_winsorized`` and write its mean and
    counters back, in place.

    The counterpart of the JAX wrapper's fix-up, without its cap of
    DEGEN_K = 128 pixels per call."""
    # host sync: the number of degenerate pixels sizes the gather
    idx = torch.nonzero(degen).flatten()
    if idx.numel():
        cols = vals.view(torch.int16).index_select(1, idx).view(torch.uint16)
        valid, v, srl, srh = _FIXUP[rejection](cols, siglow, sighigh)
        mean.view(torch.int16)[idx] = _mean_of_survivors(v, valid).view(torch.int16)
        rejl[idx] = srl
        rejh[idx] = srh
    return mean, rejl, rejh


def reject_stack(vals: torch.Tensor, rejection: str, siglow: float,
                 sighigh: float, with_counters: bool = False):
    """Rejection stack of (F, P) uint16 values -> (P,) uint16 mean (the
    median for ``rejection="median"``), or (mean, rejlow, rejhigh) with
    ``with_counters``. ``rejection`` is one of sigma, median, percentile,
    sigmedian and winsorized; percentile takes (plow, phigh) as
    (siglow, sighigh).

    Bit-exact against ``reject_and_mean`` (``masked_median`` for median),
    counters included. A CUDA tensor runs the CUDA kernel, a CPU tensor
    its plain version; then for sigma and winsorized every pixel the
    window formulation flags as degenerate is re-run exactly. The JAX
    ``reject_stack_pallas`` fixes at most DEGEN_K = 128 such pixels per
    call and leaves the window result past that; this port fixes them
    all, so past 128 degenerate pixels it matches ``reject_and_mean``
    where the fused JAX output does not. For F <= 4 every sigma and
    winsorized pixel is degenerate (the JAX package sends such stacks to
    its HBM path instead): the result is the same, only slower."""
    siglow, sighigh = float(siglow), float(sighigh)
    if vals.device.type == "cuda":
        mean, degen, rejl, rejh = reject_cuda(vals, rejection, siglow, sighigh)
    elif vals.device.type == "cpu":
        mean, degen, rejl, rejh = reject_plain(vals, rejection, siglow, sighigh)
    else:
        raise ValueError(f"no rejection kernel for device {vals.device}")
    if rejection in _FIXUP:
        mean, rejl, rejh = fix_degenerate(vals, rejection, mean, degen, rejl,
                                          rejh, siglow, sighigh)
    return (mean, rejl, rejh) if with_counters else mean


__all__ = ["reject_stack", "reject_cuda", "reject_plain", "fix_degenerate",
           "pick_tile", "launches"]
