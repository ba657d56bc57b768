"""Sigma-clip rejection stack of (F, P) uint16 pixels: the CUDA sigma
kernel (``csrc/reject_sigma.cu``), its plain PyTorch version, and the
exact re-run of degenerate pixels.

Port of ``siriltpu.ops.pallas.reject_stack``'s sigma path
(``reject_stack_pallas`` with ``rejection="sigma"``). The other fused
rejections (median, percentile, sigmedian, winsorized) are not ported yet
(ROADMAP.md Queue 2).

A CUDA tensor always goes to the kernel, and a failed build or launch
raises. A CPU tensor goes to the plain version, ``reject_sigma_window``.
"""

from __future__ import annotations

import ctypes

import torch

from siriltpu_torch.ops.rejection import (_mean_of_survivors, reject_sigma,
                                          reject_sigma_window)

#: kernel launches since the count was last set to 0 (read by
#: chip_smoke.py to show that the main path went through the kernel)
launches = 0

#: shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448
_TILES = (128, 64, 32)


def pick_tile(f: int) -> int:
    """Pixels per block for F frames: the largest tile whose (F, tile)
    uint16 slab fits in shared memory."""
    for tile in _TILES:
        if f * tile * 2 <= SMEM_LIMIT:
            return tile
    raise ValueError(f"F={f} frames do not fit the sigma kernel "
                     f"(at most {SMEM_LIMIT // (2 * _TILES[-1])})")


def _check(vals: torch.Tensor):
    if vals.dtype != torch.uint16:
        raise TypeError(f"expected uint16 values, got {vals.dtype}")
    if vals.dim() != 2 or vals.shape[0] < 1 or vals.shape[1] < 1:
        raise ValueError(f"expected non-empty (F, P) values, got {tuple(vals.shape)}")


def reject_sigma_plain(vals: torch.Tensor, siglow: float, sighigh: float):
    """The plain version of the kernel, on any device: (mean uint16,
    degen int32, rejl int32, rejh int32), each (P,)."""
    mean, rejl, rejh, degen = reject_sigma_window(vals, siglow, sighigh)
    return mean, degen.to(torch.int32), rejl, rejh


def reject_sigma_cuda(vals: torch.Tensor, siglow: float, sighigh: float):
    """Launch the CUDA sigma kernel on the current stream: (mean uint16,
    degen int32, rejl int32, rejh int32), each (P,). Asynchronous."""
    global launches
    from siriltpu_torch.utils.build import library

    _check(vals)
    if vals.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("expected contiguous (F, P) values")
    f, p = vals.shape
    tile = pick_tile(f)
    lib = library()
    dev = vals.device
    mean = torch.empty(p, dtype=torch.int16, device=dev).view(torch.uint16)
    degen, rejl, rejh = (torch.empty(p, dtype=torch.int32, device=dev)
                         for _ in range(3))
    with torch.cuda.device(dev):
        rc = lib.reject_sigma_u16(
            vals.data_ptr(), mean.data_ptr(), degen.data_ptr(),
            rejl.data_ptr(), rejh.data_ptr(), f, p, tile,
            ctypes.c_float(siglow), ctypes.c_float(sighigh),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reject_sigma_u16 launch failed: cudaError_t {rc}")
    launches += 1
    return mean, degen, rejl, rejh


def fix_degenerate(vals: torch.Tensor, mean: torch.Tensor, degen: torch.Tensor,
                   rejl: torch.Tensor, rejh: torch.Tensor, siglow: float,
                   sighigh: float):
    """Re-run every degenerate pixel through the exact masked
    ``reject_sigma`` and write its mean and counters back, in place.

    The counterpart of the JAX wrapper's fix-up, without its cap of
    DEGEN_K = 128 pixels per call."""
    # host sync: the number of degenerate pixels sizes the gather
    idx = torch.nonzero(degen).flatten()
    if idx.numel():
        cols = vals.view(torch.int16).index_select(1, idx).view(torch.uint16)
        valid, v, srl, srh = reject_sigma(cols, siglow, sighigh)
        mean.view(torch.int16)[idx] = _mean_of_survivors(v, valid).view(torch.int16)
        rejl[idx] = srl
        rejh[idx] = srh
    return mean, rejl, rejh


def reject_stack(vals: torch.Tensor, siglow: float, sighigh: float,
                 with_counters: bool = False):
    """Sigma-clip rejection stack of (F, P) uint16 values -> (P,) uint16
    mean, or (mean, rejlow, rejhigh) with ``with_counters``.

    Bit-exact against ``reject_and_mean(vals, "sigma")``, counters
    included. A CUDA tensor runs the CUDA kernel, a CPU tensor its plain
    version; then every pixel the window formulation flags as degenerate
    is re-run exactly. The JAX ``reject_stack_pallas`` fixes at most
    DEGEN_K = 128 such pixels per call and leaves the window result past
    that; this port fixes them all, so past 128 degenerate pixels it
    matches ``reject_and_mean`` where the fused JAX output does not."""
    _check(vals)
    siglow, sighigh = float(siglow), float(sighigh)
    if vals.device.type == "cuda":
        mean, degen, rejl, rejh = reject_sigma_cuda(vals, siglow, sighigh)
    elif vals.device.type == "cpu":
        mean, degen, rejl, rejh = reject_sigma_plain(vals, siglow, sighigh)
    else:
        raise ValueError(f"no sigma kernel for device {vals.device}")
    mean, rejl, rejh = fix_degenerate(vals, mean, degen, rejl, rejh,
                                      siglow, sighigh)
    return (mean, rejl, rejh) if with_counters else mean


__all__ = ["reject_stack", "reject_sigma_cuda", "reject_sigma_plain",
           "fix_degenerate", "pick_tile"]
