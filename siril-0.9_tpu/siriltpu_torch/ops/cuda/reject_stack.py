"""Rejection stack of (F, P) uint16 pixels: the six CUDA rejection
kernels (``csrc/reject_<name>.cu``) and their plain PyTorch versions.

Port of ``siriltpu.ops.pallas.reject_stack`` (``reject_stack_pallas``):
one kernel for each branch of the Pallas body — sigma, median,
percentile, sigmedian and winsorized — and, for sigma and winsorized, the
exact re-run of the pixels the window form flags as degenerate, which the
JAX wrapper does after its kernel. Here the kernels do it themselves: the
warp that owns a degenerate pixel runs the reference's masked loop on the
sorted column it holds (``exact_masked`` in ``csrc/reject_common.cuh``).
So a CUDA stack is one launch per span of pixels and no host sync. The
launches are counted (``utils.timing``, ``reject.launches.<kernel>``, and
by the form they took, ``reject.form.<kernel>.<form>``), and with tracing
on a stack is a ``stack.reject`` span that carries that form (``plain``
on the CPU route) and its degenerate pixels are counted too
(``reject.degenerate.<rejection>``, summed on the device).

How the kernels own pixels (the C plans, ``csrc/reject_<name>.cu``):
median gives each pixel a thread and its column a stride of shared
memory; percentile and sigmedian do so too, but sort a column of
F <= 128 in registers (percentile then needs no shared memory at all);
sigma gives each pixel of F <= 128 a team of one or two lanes, which sorts
and clips the column in their registers, and past that a thread; winsorized
gives each pixel a warp, ``tile`` pixels a block, and up to F = 2048
keeps the column in the warp's registers; linearfit gives each pixel a
thread, which takes the next pixel of its block's span as soon as its
own has ended, and up to F = 64 sorts the column in registers. Each
kernel's C plan is the
one place its layout is written down: ``launch_plan`` asks it for the
largest tile whose shared memory fits in the 227 KB a block may use, or,
where none fits, for the device-memory scratch copy the kernel works on
instead, so every F runs on the card. The plan names the form a launch
takes: ``wires`` (the column sorted in a thread's or a warp's
registers), ``team`` (in the registers of a team of lanes), ``shared``
(in shared memory) or ``scratch``.

``reject_stack`` is the one place that decides which code stacks a
rejection. A CUDA tensor always goes to its kernel, and a failed build or
launch raises. A CPU tensor goes to the kernel's plain version. None and
sigma_masked, which have no kernel, run ``reject_and_mean`` in plain
PyTorch on any device. Linearfit on the card is its kernel
(``linearfit_cuda``): every pixel's fit in float64, one launch and no
host sync; with tracing on, its pixel passes and the lane-pass slots it
issued are summed on the device (``reject.passes.linearfit``,
``reject.lane_slots.linearfit``). On the CPU it runs its hybrid: the
float32 fit (``reject_linearfit``), then its knife-edge pixels, gathered,
settled in float64 by ``linearfit_settle`` (a ``stack.linearfit_fixup``
span, counted in ``linearfit.knife``). Both give every word and counter
as Siril does. The settle is looked up in this module when it runs, so
that a caller may wrap it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from siriltpu_torch.ops.rejection import (_gsl_x_moments, _mean_of_survivors,
                                          linearfit_settle,
                                          masked_median, reject_and_mean,
                                          reject_linearfit,
                                          reject_percentile, reject_sigma,
                                          reject_sigma_window,
                                          reject_sigmedian, reject_winsorized,
                                          reject_winsorized_window)
from siriltpu_torch.utils.build import KERNELS, PLANNED
from siriltpu_torch.utils.timing import count, enabled, span

#: shared memory a block may use, bytes; None: all that sm_90 allows
#: (227 KB). A smaller limit sends more F to the scratch path.
SMEM_LIMIT = None
#: bytes of device-memory scratch one launch may use; more pixels run in
#: further launches
SCRATCH_BYTES = 1 << 30
#: the forms of a launch, by the code its C plan reports
FORMS = ("shared", "wires", "scratch", "team")
#: the rejections without a kernel, stacked by ``reject_and_mean``
_NO_KERNEL = ("none", "sigma_masked")
#: the window form and the exact masked loop of the rejections whose
#: kernels settle degenerate pixels
_WINDOWED = {"sigma": (reject_sigma_window, reject_sigma),
             "winsorized": (reject_winsorized_window, reject_winsorized)}


class Plan(NamedTuple):
    """A kernel's launch at F frames over P pixels, as its C plan
    (``reject_<name>_plan``, the one place the layout is written down)
    reports it."""

    tile: int           # pixels a block
    scratch: bool       # the columns live in a device-memory scratch
    chunk: int          # pixels a launch
    smem: int           # dynamic shared memory of a block, bytes
    scratch_bytes: int  # device-memory scratch of one launch, bytes
    warps: int          # warps of the kernel resident on one SM
    form: str           # where the column is sorted: one of FORMS


def launch_plan(rejection: str, f: int, p: int = 1) -> Plan:
    """How the kernel runs at F frames over p pixels on the current card:
    the largest tile whose block fits in ``SMEM_LIMIT``, or the
    device-memory scratch path in launches of at most ``SCRATCH_BYTES``."""
    from siriltpu_torch.utils.build import library

    if rejection not in PLANNED:
        raise ValueError(f"no rejection kernel {rejection!r}")
    out = (ctypes.c_int64 * 7)()
    rc = getattr(library(), f"reject_{rejection}_plan")(
        f, p, -1 if SMEM_LIMIT is None else SMEM_LIMIT, SCRATCH_BYTES, out)
    if rc != 0:
        raise RuntimeError(f"reject_{rejection}_plan failed: cudaError_t {rc}")
    return Plan(out[0], bool(out[1]), *out[2:6], FORMS[out[6]])


def _check(vals: torch.Tensor, rejection: str, names=KERNELS):
    if rejection not in names:
        raise ValueError(f"unknown rejection {rejection!r} "
                         f"(one of {', '.join(names)})")
    if vals.dtype != torch.uint16:
        raise TypeError(f"expected uint16 values, got {vals.dtype}")
    if vals.dim() != 2 or vals.shape[0] < 1 or vals.shape[1] < 1:
        raise ValueError(f"expected non-empty (F, P) values, got {tuple(vals.shape)}")


def reject_plain(vals: torch.Tensor, rejection: str, siglow: float,
                 sighigh: float):
    """The plain version of a kernel, on any device: (mean uint16, degen
    int32, rejl int32, rejh int32), each (P,). For sigma and winsorized,
    the window form, then the exact masked loop on the pixels it flags as
    degenerate, whose flag stays 1 — as the kernels do."""
    _check(vals, rejection)
    p = vals.shape[1]
    if rejection in _WINDOWED:
        window, exact = _WINDOWED[rejection]
        mean, rejl, rejh, degen = window(vals, siglow, sighigh)
        # host sync: the number of degenerate pixels sizes the gather
        idx = torch.nonzero(degen).flatten()
        if idx.numel():
            cols = vals.view(torch.int16).index_select(1, idx).view(torch.uint16)
            valid, v, srl, srh = exact(cols, siglow, sighigh)
            mean.view(torch.int16)[idx] = _mean_of_survivors(v, valid).view(torch.int16)
            rejl[idx] = srl
            rejh[idx] = srh
        return mean, degen.to(torch.int32), rejl, rejh
    z = torch.zeros(p, dtype=torch.int32, device=vals.device)
    if rejection == "median":
        return masked_median(vals), z, z, z
    fn = reject_percentile if rejection == "percentile" else reject_sigmedian
    valid, v, rejl, rejh = fn(vals, siglow, sighigh)
    return _mean_of_survivors(v, valid), z, rejl, rejh


def linearfit_hybrid(vals: torch.Tensor, siglow: float, sighigh: float,
                     columns=None):
    """The linearfit hybrid of (F, P) values on their device: the float32
    fit decides every pixel, then the pixels it flags as knife-edges are
    found in one ``nonzero`` (a host sync that sizes the gather), their
    (F, K) WORD-valued columns settled by ``linearfit_settle`` and the
    words and counters scattered back. ``columns(kidx)`` gives those
    columns on the device; by default they are ``vals``' own, which must
    then be uint16. (mean uint16, rejl int32, rejh int32), each (P,)."""
    valid, v, rejl, rejh, knife = reject_linearfit(vals, siglow, sighigh)
    mean = _mean_of_survivors(v, valid)
    del valid, v
    with span("stack.linearfit_fixup", device=vals.device) as sp:
        kidx = torch.nonzero(knife)[:, 0]
        k = int(kidx.numel())
        sp.set(K=k)
        count("linearfit.knife", k)
        if k:
            cols = (columns(kidx) if columns is not None else
                    vals.view(torch.int16).index_select(1, kidx).view(torch.uint16))
            km, rejl[kidx], rejh[kidx] = linearfit_settle(cols, (siglow, sighigh))
            mean.view(torch.int16)[kidx] = km.view(torch.int16)
    return mean, rejl, rejh


@functools.lru_cache(maxsize=None)
def _x_moments(f: int, device: torch.device) -> torch.Tensor:
    """The (4, F) float64 table the linear-fit kernel reads, made once for
    each F and kept on ``device``: ``_gsl_x_moments(f)`` (m_x and m_dx2
    for N = 1 .. F), the reciprocals of the ranks 1 .. F and of m_dx2
    (0 where m_dx2 is, at N = 1), each correctly rounded; the kernel
    divides by a rank or by m_dx2 through them, exactly."""
    moments = _gsl_x_moments(f, "cpu").numpy()
    ranks = 1.0 / np.arange(1, f + 1, dtype=np.float64)
    dx2 = np.divide(1.0, moments[1], out=np.zeros(f), where=moments[1] != 0)
    return torch.from_numpy(np.concatenate([moments, ranks[None], dx2[None]])).to(device)


def linearfit_cuda(vals: torch.Tensor, siglow: float, sighigh: float):
    """Linear-fit clipping of (F, P) uint16 values on the card, in one
    launch of ``csrc/reject_linearfit.cu`` on the current stream: (mean
    uint16, rejl int32, rejh int32), each (P,), bit-equal to
    ``linearfit_settle`` on every column. Asynchronous, with no host sync
    once the table of x moments for F is on the card."""
    return _launch_linearfit(vals, siglow, sighigh)[0]


def _launch_linearfit(vals: torch.Tensor, siglow: float, sighigh: float):
    """``linearfit_cuda``'s outputs and the plan it launched."""
    from siriltpu_torch.utils.build import library

    _check(vals, "linearfit", ("linearfit",))
    if vals.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("expected contiguous (F, P) values")
    f, p = vals.shape
    dev = vals.device
    mean = torch.empty(p, dtype=torch.int16, device=dev)
    rejl, rejh = (torch.empty(p, dtype=torch.int32, device=dev) for _ in range(2))
    # with tracing on: the pixel passes and the lane-pass slots, summed on
    # the card
    tally = torch.zeros(2, dtype=torch.int64, device=dev) if enabled() else None
    with torch.cuda.device(dev):
        plan = launch_plan("linearfit", f, p)
        moments = _x_moments(f, dev)
        scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
                   if plan.scratch else None)
        rc = library().reject_linearfit_u16(
            vals.data_ptr(), p, None if scratch is None else scratch.data_ptr(),
            plan.scratch_bytes, moments.data_ptr(), mean.data_ptr(),
            rejl.data_ptr(), rejh.data_ptr(), f, p, float(siglow),
            float(sighigh), None if tally is None else tally.data_ptr(),
            -1 if SMEM_LIMIT is None else SMEM_LIMIT, SCRATCH_BYTES,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reject_linearfit_u16 launch failed: cudaError_t {rc} (it "
                           f"takes sigs that are positive normal numbers below 2^1000)")
    count("reject.launches.linearfit")
    count(f"reject.form.linearfit.{plan.form}")
    if tally is not None:
        count("reject.passes.linearfit", tally[0])
        count("reject.lane_slots.linearfit", tally[1])
    return (mean.view(torch.uint16), rejl, rejh), plan


def reject_cuda(vals: torch.Tensor, rejection: str, siglow: float,
                sighigh: float):
    """Launch a CUDA rejection kernel on the current stream: (mean uint16,
    degen int32, rejl int32, rejh int32), each (P,). Asynchronous."""
    return _launch(vals, rejection, siglow, sighigh)[0]


def _launch(vals: torch.Tensor, rejection: str, siglow: float,
            sighigh: float):
    """``reject_cuda``'s outputs and the plan it launched."""
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
    with torch.cuda.device(dev):
        plan = launch_plan(rejection, f, p)
        scratch = (torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
                   if plan.scratch else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        launched = 0
        for a in range(0, p, plan.chunk):
            b = min(a + plan.chunk, p)
            rc = fn(vals.data_ptr() + 2 * a, p,
                    None if scratch is None else scratch.data_ptr(),
                    plan.scratch_bytes, mean.data_ptr() + 2 * a,
                    degen.data_ptr() + 4 * a, rejl.data_ptr() + 4 * a,
                    rejh.data_ptr() + 4 * a, f, b - a, plan.tile,
                    ctypes.c_float(siglow), ctypes.c_float(sighigh), stream)
            if rc != 0:
                raise RuntimeError(f"reject_{rejection}_u16 launch failed: "
                                   f"cudaError_t {rc}")
            launched += 1
    count(f"reject.launches.{rejection}", launched)
    count(f"reject.form.{rejection}.{plan.form}", launched)
    return (mean.view(torch.uint16), degen, rejl, rejh), plan


def reject_stack(vals: torch.Tensor, rejection: str, siglow: float,
                 sighigh: float, with_counters: bool = False):
    """Rejection stack of (F, P) uint16 values -> (P,) uint16 mean (the
    median for ``rejection="median"``), or (mean, rejlow, rejhigh) with
    ``with_counters``. ``rejection`` is one of sigma, median, percentile,
    sigmedian, winsorized and linearfit, which have kernels, or none and
    sigma_masked; percentile takes (plow, phigh) as (siglow, sighigh).

    Bit-exact against ``reject_and_mean`` (``masked_median`` for median),
    counters included. A CUDA tensor runs the CUDA kernel, a CPU tensor
    its plain version; for sigma and winsorized both settle every pixel
    the window formulation flags as degenerate with the exact masked
    loop. The JAX ``reject_stack_pallas`` fixes at most DEGEN_K = 128
    such pixels per call and leaves the window result past that; this
    port settles them all, so past 128 degenerate pixels it matches
    ``reject_and_mean`` where the fused JAX output does not. For F <= 4
    every sigma and winsorized pixel is degenerate (the JAX package sends
    such stacks to its HBM path instead): the result is the same, only
    slower. The CUDA route makes no host sync. None and sigma_masked run
    ``reject_and_mean`` on any device. Linearfit is bit-equal to
    ``verify.oracle.c_reject_block``: on the card its kernel settles every
    pixel in float64; on the CPU its hybrid syncs once a pass of its
    float32 fit and once to gather its knife-edge pixels."""
    siglow, sighigh = float(siglow), float(sighigh)
    _check(vals, rejection, PLANNED + _NO_KERNEL)
    with span("stack.reject", device=vals.device, shape=tuple(vals.shape),
              rejection=rejection) as sp:
        if rejection == "linearfit" and vals.device.type == "cuda":
            (mean, rejl, rejh), plan = _launch_linearfit(vals, siglow, sighigh)
            sp.set(form=plan.form)
        elif rejection == "linearfit":
            mean, rejl, rejh = linearfit_hybrid(vals, siglow, sighigh)
            sp.set(form="hybrid")
        elif rejection in _NO_KERNEL:
            mean, rejl, rejh = reject_and_mean(vals, rejection, (siglow, sighigh))
            sp.set(form="plain")
        elif vals.device.type == "cuda":
            (mean, degen, rejl, rejh), plan = _launch(vals, rejection, siglow,
                                                      sighigh)
            sp.set(form=plan.form)
        elif vals.device.type == "cpu":
            mean, degen, rejl, rejh = reject_plain(vals, rejection, siglow, sighigh)
            sp.set(form="plain")
        else:
            raise ValueError(f"no rejection kernel for device {vals.device}")
        if rejection in _WINDOWED and enabled():
            count(f"reject.degenerate.{rejection}", degen.sum())
    return (mean, rejl, rejh) if with_counters else mean


__all__ = ["reject_stack", "reject_cuda", "reject_plain", "linearfit_hybrid",
           "linearfit_cuda",
           "launch_plan", "Plan"]
