"""Pixel rejection, vectorized over pixels — the plain PyTorch versions
of the CUDA rejection kernels, including the exact masked loops that
settle the pixels the window forms flag as degenerate.

Port of ``siriltpu.ops.rejection``.
Reference: src/stacking/stacking.c:1128-1186 (clip predicates) and
:1656-1788 (the per-pixel loops). Semantics frozen, as in the JAX package:

- the per-pixel cross-frame vector is sorted, then iteratively clipped
  around the GSL sorted-median using the GSL SAMPLE standard deviation
  (N-1 denominator, gsl_stats_ushort_sd);
- loops run while any pixel was rejected and more than 3 survive;
- flagging stops early within a pass once ``N - r <= 4`` where ``r``
  accumulates across passes (stacking.c:1684-1688). Positions after the
  break keep *stale* flags in the reused ``rejected[]`` buffer, and the
  removal loop consumes them without counting them (see _stale_pass);
- SIGMEDIAN replaces rejected values by round_to_WORD(median) instead of
  removing them (:1696-1708);
- WINSORIZED iterates (clamp to median +- 1.5 sigma, re-measure the median
  and 1.134 sd) until |sigma - sigma0| / sigma0 <= 5e-4, then sigma-clips
  the ORIGINAL values with the converged sigma and median (:1710-1748);
- LINEARFIT fits value against rank by least squares, sigma = mean
  |residual| (:1750-1783);
- PERCENTILE is one pass on the relative distance from the median
  (:1130-1143), removing only if N > 1 (:1667-1673);
- final pixel = round_to_WORD(mean of survivors) (:1790-1794).

Every statistic is computed as in the JAX package, down to the order of
the float32 operations, because the f32 sigma decides which values are
clipped: integer sums are exact, and only the final combine is f32.

Shapes: ``vals`` is (F, P) — F frames, P pixels. Values are WORD-valued
(uint16, int32 or integer-valued float32).
"""

from __future__ import annotations

import numpy as np
import torch

from siriltpu_torch.ops.sortnet import sort_axis0
from siriltpu_torch.utils.interop import (i32_to_u16, to_float32, u16_to_i32,
                                          u16_to_numpy)
from siriltpu_torch.utils.rounding import round_to_word_f
from siriltpu_torch.utils.timing import count

Tensor = torch.Tensor

# Safety bound only: the reference loops are data-terminating (every pass
# removes >= 1 element). A 128-frame golden vector takes 61 passes, so the
# bound must stay well above F.
MAX_ITERS = 512

# invalid slots of the winsorized working copy sort above every value
_INVALID = 1e9


def _f32(x: float, device) -> Tensor:
    """A float32 scalar on ``device``: the clip multiplies sigma by
    f32(siglow) in f32, as JAX does with a weakly typed Python float."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _where_u16(cond: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``torch.where`` on uint16 tensors, through int16 views."""
    return torch.where(cond, a.view(torch.int16),
                       b.view(torch.int16)).view(torch.uint16)


# ------------------------------------------------------------- mask helpers

def _kth_valid(vals: Tensor, cum: Tensor, k: Tensor, valid: Tensor) -> Tensor:
    """Value of the k-th (0-based) valid element per pixel.

    ``cum`` is the inclusive cumsum of the validity mask along axis 0.
    The hit is restricted to VALID slots: invalid slots repeat the cum
    value of the preceding valid slot."""
    hit = (cum == (k[None, :] + 1)) & valid
    return torch.where(hit, vals, 0.0).sum(dim=0)


def _gsl_median(vals: Tensor, valid: Tensor, n: Tensor) -> Tensor:
    """GSL sorted-median over the valid elements (mean of the two middle
    order statistics for even n)."""
    cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    v1 = _kth_valid(vals, cum, (n - 1) // 2, valid)
    v2 = _kth_valid(vals, cum, n // 2, valid)
    return torch.where(n > 0, 0.5 * (v1 + v2), 0.0)


def _gsl_sd(vals: Tensor, valid: Tensor, n: Tensor) -> Tensor:
    """gsl_stats_ushort_sd over the valid subset.

    ``vals`` are integer-valued f32. The sums are exact integers:
    deviations are centred on the upper middle order statistic and the
    squares use a hi/lo 8-bit split. One final f32 combine, in the JAX
    package's order of operations."""
    cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    anchor = torch.floor(_kth_valid(vals, cum, n // 2, valid)).to(torch.int32)
    vi = torch.where(valid, vals, 0.0).to(torch.int32)
    return _sd_of_deviations(torch.where(valid, vi - anchor[None, :], 0), n)


def _sd_of_deviations(d: Tensor, n: Tensor) -> Tensor:
    """Sample sd of n values from their (F, P) int32 deviations ``d`` from
    an anchor (0 where a value is not counted): exact integer sums of an
    8-bit split of |d|, then one f32 combine in the JAX package's order of
    operations."""
    nf = n.to(torch.float32)
    s1 = d.sum(dim=0)
    ad = d.abs()
    hi8 = ad >> 8
    lo8 = ad & 255
    s2 = ((hi8 * hi8).sum(dim=0).to(torch.float32) * 65536.0
          + (hi8 * lo8).sum(dim=0).to(torch.float32) * 512.0
          + (lo8 * lo8).sum(dim=0).to(torch.float32))
    s1f = s1.to(torch.float32)
    var = ((s2 - s1f * s1f / torch.clamp(nf, min=1.0))
           / torch.clamp(nf - 1.0, min=1.0))
    return torch.where(n > 1, torch.sqrt(torch.clamp(var, min=0.0)), 0.0)


def _mean_of_survivors(vals: Tensor, valid: Tensor) -> Tensor:
    """round_to_WORD(sum / N) of integer-valued survivors, in exact
    integer arithmetic: floor(s/n + 0.5) == (2s + n) // (2n). uint16."""
    n = valid.sum(dim=0).to(torch.int32)
    s = torch.where(valid, vals, 0.0).to(torch.int32).sum(dim=0)
    m = torch.where(n > 0, (2 * s + n) // torch.clamp(2 * n, min=1), 0)
    return i32_to_u16(m.clamp(0, 65535))


def _stale_pass(valid: Tensor, buf: Tensor, r_prev: Tensor, low: Tensor,
                high: Tensor, n: Tensor):
    """One flag+removal pass with the C's full quirk set
    (stacking.c:1674-1694): the flag scan walks the survivors in sorted
    order writing into a POSITIONAL buffer ``rejected[rank]``, counting
    ``r`` cumulatively, and breaking once ``N - r <= 4``; the removal loop
    then reads ``rejected[rank]`` for ALL ranks — positions past the break
    keep STALE flags from the previous pass, which remove elements
    without being counted.

    ``buf`` is the (F, P) int8 positional buffer (index = rank among the
    currently valid elements). Returns (new_valid, new_buf, r_new,
    removed, cnt_low, cnt_high)."""
    f, p = valid.shape
    fresh = low | high
    c = torch.cumsum(fresh, dim=0, dtype=torch.int32)
    # break at rank j iff after counting j's flag, N - r <= 4; only valid
    # slots are scan steps. The element hosting the break IS visited.
    broke = ((n[None, :] - (r_prev[None, :] + c)) <= 4) & valid
    broke_seen = torch.cumsum(broke, dim=0, dtype=torch.int32) > 0
    broke_before = torch.cat([torch.zeros_like(broke[:1]), broke_seen[:-1]])
    visited = valid & ~broke_before
    cnt_l = (low & visited).sum(dim=0).to(torch.int32)
    cnt_h = (high & visited).sum(dim=0).to(torch.int32)
    r_new = r_prev + (fresh & visited).sum(dim=0).to(torch.int32)
    rank = torch.cumsum(valid, dim=0, dtype=torch.int32) - 1
    buf_at = torch.gather(buf, 0, rank.clamp(0, f - 1).long())
    sign = torch.where(low, -1, torch.where(high, 1, 0)).to(torch.int8)
    entry = torch.where(visited, sign, buf_at)
    remove = valid & (entry != 0)
    # scatter entries to their ranks; invalid slots write to a spare row
    # that is dropped (JAX: mode="drop")
    idx = torch.where(valid, rank, f).long()
    buf_ext = torch.cat([buf, torch.zeros_like(buf[:1])])
    buf_ext.scatter_(0, idx, torch.where(valid, entry, 0).to(torch.int8))
    new_valid = valid & ~remove
    removed = remove.sum(dim=0).to(torch.int32)
    return new_valid, buf_ext[:f], r_new, removed, cnt_l, cnt_h


def _sigma_flags(vals: Tensor, valid: Tensor, median: Tensor, sigma: Tensor,
                 siglow: float, sighigh: float):
    """sigma_clipping (stacking.c:1148-1160): returns (low, high) flags."""
    dev = sigma.device
    low = (median[None, :] - vals > _f32(siglow, dev) * sigma[None, :]) & valid
    high = (vals - median[None, :] > _f32(sighigh, dev) * sigma[None, :]) & valid
    return low, high


# ------------------------------------------------------------- algorithms

def reject_sigma(vals: Tensor, siglow: float, sighigh: float,
                 active: Tensor = None, presorted: bool = False):
    """SIGMA rejection (stacking.c:1674-1694), masked formulation. Returns
    (valid mask over the SORTED values, sorted float32 values, rejl, rejh).

    ``active`` (P,) bool: pixels to process; inactive pixels start done
    (their valid mask stays all-true and counters stay 0). ``presorted``
    skips the sort when the caller already sorted along axis 0."""
    f, p = vals.shape
    dev = vals.device
    sv = to_float32(vals if presorted else sort_axis0(vals))
    valid = torch.ones((f, p), dtype=torch.bool, device=dev)
    done = (torch.zeros(p, dtype=torch.bool, device=dev) if active is None
            else ~active)
    z = torch.zeros(p, dtype=torch.int32, device=dev)
    r, rejl, rejh = z, z, z
    buf = torch.zeros((f, p), dtype=torch.int8, device=dev)
    it = 0
    # one host sync per pass: the loop runs until every pixel is done
    while it < MAX_ITERS and not bool(done.all()):
        n = valid.sum(dim=0).to(torch.int32)
        sigma = _gsl_sd(sv, valid, n)
        median = _gsl_median(sv, valid, n)
        low, high = _sigma_flags(sv, valid, median, sigma, siglow, sighigh)
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        # freeze pixels that are done
        upd = ~done
        valid = torch.where(upd[None, :], new_valid, valid)
        buf = torch.where(upd[None, :], new_buf, buf)
        rejl = rejl + torch.where(upd, cnt_l, 0)
        rejh = rejh + torch.where(upd, cnt_h, 0)
        r = torch.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        it += 1
    return valid, sv, rejl, rejh


def reject_sigmedian(vals: Tensor, siglow: float, sighigh: float):
    """SIGMEDIAN (stacking.c:1696-1708): rejected values are replaced by
    round_to_WORD(median) and the vector is sorted again; nothing is
    removed. The first pass always runs. Returns (valid, values, rejl,
    rejh)."""
    f, p = vals.shape
    dev = vals.device
    v = to_float32(sort_axis0(vals))
    valid = torch.ones((f, p), dtype=torch.bool, device=dev)
    n = torch.full((p,), f, dtype=torch.int32, device=dev)
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    rejl = torch.zeros(p, dtype=torch.int32, device=dev)
    rejh = torch.zeros_like(rejl)
    it = 0
    # one host sync per pass: the loop runs until every pixel is done
    while it < MAX_ITERS and not bool(done.all()):
        sigma = _gsl_sd(v, valid, n)
        median = _gsl_median(v, valid, n)
        low, high = _sigma_flags(v, valid, median, sigma, siglow, sighigh)
        flags = low | high
        nrep = flags.sum(dim=0)
        medw = round_to_word_f(median)
        v = sort_axis0(torch.where(flags & ~done[None, :], medw[None, :], v))
        rejl = rejl + torch.where(~done, low.sum(dim=0).to(torch.int32), 0)
        rejh = rejh + torch.where(~done, high.sum(dim=0).to(torch.int32), 0)
        done = done | (nrep == 0) | (n <= 3)
        it += 1
    return valid, v, rejl, rejh


def reject_winsorized(vals: Tensor, siglow: float, sighigh: float):
    """WINSORIZED sigma clipping (stacking.c:1710-1748), masked
    formulation, with the reference's stale-buffer quirks (_stale_pass).

    All statistics are centred on an integer anchor, the middle order
    statistic, as in the JAX package: every step is shift-equivariant,
    and centring keeps the f32 fixed point away from ulp(65535). Returns
    (valid mask over the SORTED values, sorted float32 values, rejl,
    rejh)."""
    f, p = vals.shape
    dev = vals.device
    sv_orig = to_float32(sort_axis0(vals))
    anchor = torch.floor(sv_orig[f // 2])
    sv = sv_orig - anchor[None, :]
    lo_clip = -anchor
    hi_clip = 65535.0 - anchor
    c15, c1134 = _f32(1.5, dev), _f32(1.134, dev)
    tiny, tol = _f32(1e-30, dev), _f32(0.0005, dev)

    def round_shift(x):
        r = torch.floor(x + 0.5)
        r = torch.where(x <= lo_clip, lo_clip, r)
        return torch.where(x > hi_clip, hi_clip, r)

    def winsor_converge(valid, n):
        """The fixed point: winsorize until sigma converges. Returns
        (median, sigma)."""
        sig = _gsl_sd(sv, valid, n)
        med = _gsl_median(sv, valid, n)
        w = torch.where(valid, sv, _INVALID)
        conv = torch.zeros(p, dtype=torch.bool, device=dev)
        it = 0
        # one host sync per step: it runs until every pixel converged
        while it < MAX_ITERS and not bool(conv.all()):
            m0 = med - c15 * sig
            m1 = med + c15 * sig
            clamped = torch.where(
                w < m0[None, :], round_shift(m0)[None, :],
                torch.where(w > m1[None, :], round_shift(m1)[None, :], w))
            # clamping the tails is monotone: the sorted order (and the
            # _INVALID slots at the top) survive without a re-sort
            wv = torch.where(w < _INVALID / 2, clamped, w)
            wvalid = wv < _INVALID / 2
            med_new = _gsl_median(wv, wvalid, n)
            sig_new = c1134 * _gsl_sd(wv, wvalid, n)
            newconv = (sig <= 0) | (
                torch.abs(sig_new - sig) / torch.maximum(sig, tiny) <= tol)
            # freeze converged pixels
            w = torch.where(conv[None, :], w, wv)
            med = torch.where(conv, med, med_new)
            sig = torch.where(conv, sig, sig_new)
            conv = conv | newconv
            it += 1
        return med, sig

    valid = torch.ones((f, p), dtype=torch.bool, device=dev)
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    z = torch.zeros(p, dtype=torch.int32, device=dev)
    r, rejl, rejh = z, z, z
    buf = torch.zeros((f, p), dtype=torch.int8, device=dev)
    it = 0
    while it < MAX_ITERS and not bool(done.all()):
        n = valid.sum(dim=0).to(torch.int32)
        median, sigma = winsor_converge(valid, n)
        low, high = _sigma_flags(sv, valid, median, sigma, siglow, sighigh)
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        upd = ~done
        valid = torch.where(upd[None, :], new_valid, valid)
        buf = torch.where(upd[None, :], new_buf, buf)
        rejl = rejl + torch.where(upd, cnt_l, 0)
        rejh = rejh + torch.where(upd, cnt_h, 0)
        r = torch.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        it += 1
    return valid, sv_orig, rejl, rejh


#: residual/sigma ratios closer than this to the clip threshold are
#: knife-edges the f32 fit cannot decide reliably against the C's f64
#: math; such pixels are flagged for the exact float64 settle
#: (linearfit_settle). The f32 relative error of the fit+ratio chain
#: is ~F * 2**-24 ~ 1e-5 at F = 100; 1e-4 leaves a tenfold guard band,
#: which also absorbs the order of the f32 sums over F, while flagging
#: next to nothing on real (continuous-noise) data.
LINEARFIT_KNIFE_EPS = 1e-4


def reject_linearfit(vals: Tensor, siglow: float, sighigh: float):
    """LINEARFIT rejection (stacking.c:1750-1783): least-squares line over
    (rank, sorted value), sigma = mean |residual|, clip by residual.

    Returns ``(valid, sorted_vals, rejlow, rejhigh, knife)``: ``knife``
    marks pixels whose clip decision came within LINEARFIT_KNIFE_EPS of
    the threshold at any pass (settle those in float64 for bit-exactness,
    see linearfit_settle). Its passes are counted (``linearfit.passes``,
    each one host check of ``done.all()``)."""
    f, p = vals.shape
    dev = vals.device
    sv_orig = to_float32(sort_axis0(vals))
    # f32 guard (as in reject_winsorized): the fit and its residual test
    # are shift-equivariant, so centre on an integer anchor to keep the
    # intercept and residual math away from ulp(65535) ~ 0.004
    anchor = torch.floor(sv_orig[f // 2])
    sv = sv_orig - anchor[None, :]
    sl, sh = _f32(siglow, dev), _f32(sighigh, dev)
    tiny, eps = _f32(1e-30, dev), _f32(LINEARFIT_KNIFE_EPS, dev)
    inf = _f32(float("inf"), dev)
    valid = torch.ones((f, p), dtype=torch.bool, device=dev)
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    knife = torch.zeros_like(done)
    z = torch.zeros(p, dtype=torch.int32, device=dev)
    r, rejl, rejh = z, z, z
    buf = torch.zeros((f, p), dtype=torch.int8, device=dev)
    it = 0
    # one host sync per pass: the loop runs until every pixel is done
    while it < MAX_ITERS and not bool(done.all()):
        n = valid.sum(dim=0).to(torch.int32)
        nf1 = torch.clamp(n.to(torch.float32), min=1.0)
        cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
        rank = torch.where(valid, (cum - 1).to(torch.float32), 0.0)
        y = torch.where(valid, sv, 0.0)
        xm = rank.sum(dim=0) / nf1
        ym = y.sum(dim=0) / nf1
        dx = torch.where(valid, rank - xm[None, :], 0.0)
        dy = torch.where(valid, sv - ym[None, :], 0.0)
        ssxx = (dx * dx).sum(dim=0)
        a = torch.where(ssxx > 0,
                        (dx * dy).sum(dim=0) / torch.maximum(ssxx, tiny), 0.0)
        b = ym - a * xm
        fitv = a[None, :] * rank + b[None, :]
        resid = torch.where(valid, torch.abs(sv - fitv), 0.0)
        sigma = resid.sum(dim=0) / nf1
        safe_sig = torch.maximum(sigma, tiny)
        ratio_lo = (fitv - sv) / safe_sig[None, :]
        ratio_hi = (sv - fitv) / safe_sig[None, :]
        sig_pos = (sigma > 0)[None, :]
        low = (ratio_lo > sl) & valid & sig_pos
        high = (ratio_hi > sh) & valid & sig_pos
        # knife-edge detection: any frame's clip ratio within EPS of its
        # threshold on an active pixel means f32 may disagree with the
        # C's f64 decision: flag the pixel for the exact re-run
        m = torch.where(valid & sig_pos,
                        torch.minimum(torch.abs(ratio_lo - sl),
                                      torch.abs(ratio_hi - sh)), inf)
        knife = knife | (~done & (m.amin(dim=0) < eps))
        new_valid, new_buf, r_new, removed, cnt_l, cnt_h = _stale_pass(
            valid, buf, r, low, high, n)
        n_new = n - removed
        upd = ~done
        valid = torch.where(upd[None, :], new_valid, valid)
        buf = torch.where(upd[None, :], new_buf, buf)
        rejl = rejl + torch.where(upd, cnt_l, 0)
        rejh = rejh + torch.where(upd, cnt_h, 0)
        r = torch.where(upd, r_new, r)
        done = done | (removed == 0) | (n_new <= 3)
        it += 1
    count("linearfit.passes", it)
    return valid, sv_orig, rejl, rejh, knife


def reject_percentile(vals: Tensor, plow: float, phigh: float):
    """PERCENTILE clipping (stacking.c:1130-1143, loop :1656-1673): one
    pass on the relative distance from the median; values are removed
    only if N > 1. Returns (valid, sorted float32 values, rejl, rejh)."""
    f, p = vals.shape
    dev = vals.device
    sv = to_float32(sort_axis0(vals))
    valid = torch.ones((f, p), dtype=torch.bool, device=dev)
    n = torch.full((p,), f, dtype=torch.int32, device=dev)
    median = _gsl_median(sv, valid, n)
    medsafe = torch.where(median == 0, _f32(1e-30, dev), median)
    low = (median[None, :] - sv) / medsafe[None, :] > _f32(plow, dev)
    high = (sv - median[None, :]) / medsafe[None, :] > _f32(phigh, dev)
    flags = low | high
    if f > 1:
        # removal scans ascending and stops at N == 1: if every value is
        # flagged, the last (largest) one survives (stacking.c:1667-1673)
        all_flagged = flags.all(dim=0)
        is_last = torch.arange(f, device=dev)[:, None] == f - 1
        valid = torch.where(all_flagged[None, :], is_last, ~flags)
    return (valid, sv, low.sum(dim=0).to(torch.int32),
            high.sum(dim=0).to(torch.int32))


def reject_none(vals: Tensor):
    """No rejection: every value survives. Returns (valid, float32
    values, rejl, rejh)."""
    f, p = vals.shape
    z = torch.zeros(p, dtype=torch.int32, device=vals.device)
    return (torch.ones((f, p), dtype=torch.bool, device=vals.device),
            to_float32(vals), z, z)


def masked_median(vals: Tensor) -> Tensor:
    """Median stack pixel op (stacking.c:765-767): the GSL sorted median
    of every pixel's values, truncated toward zero to WORD as the C
    assignment does. The plain version of the CUDA median kernel.
    uint16 (P,)."""
    f, p = vals.shape
    sv = to_float32(sort_axis0(vals))
    valid = torch.ones((f, p), dtype=torch.bool, device=vals.device)
    n = torch.full((p,), f, dtype=torch.int32, device=vals.device)
    return i32_to_u16(_gsl_median(sv, valid, n).to(torch.int32))


def reject_sigma_window(vals: Tensor, siglow: float, sighigh: float,
                        presorted: bool = False):
    """SIGMA rejection, window formulation — the plain version of the CUDA
    sigma kernel.

    On the sorted pixel vector, sigma clipping removes a PREFIX (low
    rejects) and a SUFFIX (high rejects), so the survivors are a window
    [lo, hi). Statistics use the same exact integer sums as _gsl_sd,
    centred as there on the upper middle value x[lo + n // 2], so the
    float32 sd is _gsl_sd's word for word; the mean is exact integer
    round-half-up.

    The reference's mid-scan break (N - r <= 4) with its stale-buffer
    removals is not window-shaped: any pixel whose scan WOULD hit the
    break (n - r - flags <= 4 at some pass) is flagged DEGENERATE and
    frozen; callers re-run exactly those pixels through reject_sigma.

    Returns (mean uint16 (P,), rejl, rejh, degenerate bool (P,))."""
    f, p = vals.shape
    dev = vals.device
    sv = vals if presorted else sort_axis0(vals)
    if sv.dtype == torch.uint16:
        sv = u16_to_i32(sv)
    svi = sv.to(torch.int32)
    svf = sv.to(torch.float32)
    iota = torch.arange(f, dtype=torch.int32, device=dev)[:, None]
    sl, sh = _f32(siglow, dev), _f32(sighigh, dev)

    def win_stats(lo, hi):
        n = hi - lo
        mask = (iota >= lo[None, :]) & (iota < hi[None, :])
        v1 = _at(svi, lo + (n - 1) // 2)
        v2 = _at(svi, lo + n // 2)
        median = 0.5 * (v1 + v2).to(torch.float32)
        # exact-integer sigma, centred as _gsl_sd on the upper middle value
        sigma = _sd_of_deviations(torch.where(mask, svi - v2[None, :], 0), n)
        return n, mask, median, sigma

    z = torch.zeros(p, dtype=torch.int32, device=dev)
    lo, hi, r = z, torch.full_like(z, f), z
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    degen = torch.zeros_like(done)
    it = 0
    # one host sync per pass: the loop runs until every pixel is done
    while it < MAX_ITERS and not bool(done.all()):
        n, mask, median, sigma = win_stats(lo, hi)
        low = mask & (median[None, :] - svf > sl * sigma[None, :])
        high = mask & (svf - median[None, :] > sh * sigma[None, :])
        lo, hi, r, done, degen = _window_step(low, high, n, lo, hi, r, done, degen)
        it += 1
    return _window_mean(svi, iota, lo, hi), lo, f - hi, degen


def reject_winsorized_window(vals: Tensor, siglow: float, sighigh: float,
                             presorted: bool = False):
    """WINSORIZED rejection, window formulation — the plain version of the
    CUDA winsorized kernel, and the PyTorch counterpart of the Pallas
    winsorized body (siriltpu/ops/pallas/reject_stack.py:611-795), as
    reject_sigma_window is the sigma body's.

    Per pixel, on the sorted vector shifted by anchor = x[F // 2]: each
    pass of the outer clip starts the fixed point from the window [lo, hi)
    (its median, and its sd anchored on element lo + n // 2) and re-seeds
    the working copy from the unclamped values; a fixed-point step clamps
    the window to round_shift(med -+ 1.5 sigma) and takes sigma = 1.134 sd
    of the clamped window, again anchored on lo + n // 2, until
    |dsigma| / sigma <= 5e-4 or sigma <= 0, at most MAX_ITERS steps. The
    outer clip is sigma's predicate on the unclamped values, with sigma's
    DEGENERATE rule; callers re-run degenerate pixels through
    reject_winsorized. The working copy is carried as two bounds a pixel,
    clamp(values, A, B), as the kernel carries it.

    Returns (mean uint16 (P,), rejl, rejh, degenerate bool (P,))."""
    f, p = vals.shape
    dev = vals.device
    sv = vals if presorted else sort_axis0(vals)
    if sv.dtype == torch.uint16:
        sv = u16_to_i32(sv)
    sv = sv.to(torch.int32)
    iota = torch.arange(f, dtype=torch.int32, device=dev)[:, None]
    sl, sh = _f32(siglow, dev), _f32(sighigh, dev)
    c15, c1134 = _f32(1.5, dev), _f32(1.134, dev)
    tiny, tol = _f32(1e-30, dev), _f32(0.0005, dev)
    anchor = sv[f // 2]
    svi = sv - anchor[None, :]
    svf = svi.to(torch.float32)
    lo_clip = (-anchor).to(torch.float32)
    hi_clip = 65535.0 - anchor.to(torch.float32)

    def round_shift(t):
        r = torch.floor(t + 0.5)
        r = torch.where(t <= lo_clip, lo_clip, r)
        return torch.where(t > hi_clip, hi_clip, r).to(torch.int32)

    def stats(v, lo, n, mask):
        """(median, sd) of v's window, the sd anchored on lo + n // 2."""
        a = _at(v, lo + n // 2)
        median = 0.5 * (_at(v, lo + (n - 1) // 2) + a).to(torch.float32)
        return median, _sd_of_deviations(torch.where(mask, v - a[None, :], 0), n)

    def clamp(v, a, b):
        return torch.minimum(torch.maximum(v, a), b)

    z = torch.zeros(p, dtype=torch.int32, device=dev)
    lo, hi, r = z, torch.full_like(z, f), z
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    degen = torch.zeros_like(done)
    it = 0
    # one host sync per pass and per step: each loop runs until every
    # pixel is done (converged)
    while it < MAX_ITERS and not bool(done.all()):
        n = hi - lo
        mask = (iota >= lo[None, :]) & (iota < hi[None, :])
        med, sig = stats(svi, lo, n, mask)
        # the working copy is clamp(svi, A, B): the integer clamp equals
        # the reference's where-chain on integer values and keeps the
        # window sorted, and clamps compose, clamp(clamp(v, A, B), r0, r1)
        # == clamp(v, clamp(A, r0, r1), clamp(B, r0, r1)), so two bounds a
        # pixel carry it from step to step, as in the CUDA kernel
        lo_b, hi_b = (-anchor).to(torch.int32), (65535 - anchor).to(torch.int32)
        conv = done
        iit = 0
        while iit < MAX_ITERS and not bool(conv.all()):
            r0 = round_shift(med - c15 * sig)
            r1 = round_shift(med + c15 * sig)
            a_new, b_new = clamp(lo_b, r0, r1), clamp(hi_b, r0, r1)
            med_new, sd_new = stats(clamp(svi, a_new[None, :], b_new[None, :]),
                                    lo, n, mask)
            sig_new = c1134 * sd_new
            newconv = (sig <= 0) | (
                torch.abs(sig_new - sig) / torch.maximum(sig, tiny) <= tol)
            lo_b = torch.where(conv, lo_b, a_new)
            hi_b = torch.where(conv, hi_b, b_new)
            med = torch.where(conv, med, med_new)
            sig = torch.where(conv, sig, sig_new)
            conv = conv | newconv
            iit += 1
        low = mask & (med[None, :] - svf > sl * sig[None, :])
        high = mask & (svf - med[None, :] > sh * sig[None, :])
        lo, hi, r, done, degen = _window_step(low, high, n, lo, hi, r, done, degen)
        it += 1
    return _window_mean(sv, iota, lo, hi), lo, f - hi, degen


def _window_step(low: Tensor, high: Tensor, n: Tensor, lo: Tensor, hi: Tensor,
                 r: Tensor, done: Tensor, degen: Tensor):
    """One pass of a windowed clip on its (F, P) low and high flags: move
    the window [lo, hi) of every pixel not done, and end the pixels that
    removed nothing or keep at most 3 values. The C scan breaks iff
    n - (r + c) <= 4 for some prefix count c of flags (max c = nlow +
    nhigh, incl. c == 0 when n - r <= 4 already): such a pixel is frozen
    and flagged DEGENERATE. Every counted low reject advanced lo and every
    high one lowered hi, so the counters are lo and F - hi. Returns (lo,
    hi, r, done, degen)."""
    nlow = low.sum(dim=0).to(torch.int32)
    nhigh = high.sum(dim=0).to(torch.int32)
    removed = nlow + nhigh
    hits_break = (n - r - removed) <= 4
    upd = ~done & ~hits_break
    lo = torch.where(upd, lo + nlow, lo)
    hi = torch.where(upd, hi - nhigh, hi)
    r = torch.where(upd, r + removed, r)
    degen = degen | (~done & hits_break)
    done = done | hits_break | (removed == 0) | ((hi - lo) <= 3)
    return lo, hi, r, done, degen


def _at(v: Tensor, k: Tensor) -> Tensor:
    """v[k[j], j] for every pixel j."""
    return torch.gather(v, 0, k[None, :].long())[0]


def _window_mean(sv: Tensor, iota: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """round_to_WORD of the exact integer mean of sv[lo:hi] per pixel.
    uint16."""
    mask = (iota >= lo[None, :]) & (iota < hi[None, :])
    n = hi - lo
    s = torch.where(mask, sv, 0).sum(dim=0)
    mean = torch.where(n > 0, (2 * s + n) // torch.clamp(2 * n, min=1), 0)
    return i32_to_u16(mean.clamp(0, 65535))


_MASKED = {"sigma_masked": reject_sigma, "percentile": reject_percentile,
           "sigmedian": reject_sigmedian, "winsorized": reject_winsorized}


def reject_and_mean(vals: Tensor, rejection: str, sig=(3.0, 3.0)):
    """Full rejection + mean for a (F, P) block of WORD-valued pixels.

    Returns (uint16 mean (P,), rejlow (P,), rejhigh (P,)).

    ``sigma`` is a HYBRID: the window formulation handles every pixel,
    and the rare pixels that hit the reference's degenerate mid-scan
    break are re-run through the reference-exact masked formulation.
    ``sigma_masked`` runs the masked loop for everything, and so do
    percentile, sigmedian and winsorized, as in the JAX package.
    ``linearfit`` is the plain f32 fit, as in the JAX package, without the
    float64 settle of its knife-edge pixels (``reject_stack`` has it)."""
    siglow, sighigh = float(sig[0]), float(sig[1])
    if rejection == "sigma":
        sv = sort_axis0(vals)
        mean, rejl, rejh, degen = reject_sigma_window(
            sv, siglow, sighigh, presorted=True)
        # with no degenerate pixel the masked loop exits before its
        # first pass
        valid, v, srl, srh = reject_sigma(
            sv, siglow, sighigh, active=degen, presorted=True)
        mean = _where_u16(degen, _mean_of_survivors(v, valid), mean)
        rejl = torch.where(degen, srl, rejl)
        rejh = torch.where(degen, srh, rejh)
        return mean, rejl, rejh
    if rejection in ("none", None):
        valid, v, rejl, rejh = reject_none(vals)
    elif rejection in _MASKED:
        valid, v, rejl, rejh = _MASKED[rejection](to_float32(vals), siglow,
                                                  sighigh)
    elif rejection == "linearfit":
        valid, v, rejl, rejh, _knife = reject_linearfit(vals, siglow, sighigh)
    else:
        raise ValueError(f"unknown rejection {rejection!r}")
    return _mean_of_survivors(v, valid), rejl, rejh


def _gsl_x_moments(f: int, device) -> Tensor:
    """gsl_fit_linear's moments of x = 0 .. n-1 for every n = 1 .. f, which
    depend on n alone: row 0 the running mean m_x, row 1 the running mean
    of dx * dx, (2, f) float64, entry n - 1 for n values. The NumPy float64
    operations of ``verify.oracle.gsl_fit_linear``, one at a time, over
    every n at once."""
    n = np.arange(1, f + 1)
    m_x = np.zeros(f)
    m_dx2 = np.zeros(f)
    for i in range(f):
        step = m_x + (np.float64(i) - m_x) / np.float64(i + 1.0)
        m_x = np.where(i < n, step, m_x)
    for i in range(f):
        dx = np.float64(i) - m_x
        step = m_dx2 + (dx * dx - m_dx2) / np.float64(i + 1.0)
        m_dx2 = np.where(i < n, step, m_dx2)
    return torch.from_numpy(np.stack([m_x, m_dx2])).to(device)


def linearfit_settle(columns: Tensor, sig):
    """LINEARFIT (stacking.c:1750-1783) of every column of a (F, K)
    WORD-valued tensor, in float64 and in the C's order of operations, so
    that each word and counter is ``verify.oracle.c_reject_block``'s: the
    exact path for the pixels whose float32 fit came within
    LINEARFIT_KNIFE_EPS of a clip (``reject_stack``, the block loop).

    Vectorised over the K columns; loops over the frames and the passes
    (one host check a pass). A pass is the C's: the survivors, kept
    packed at the head of each column in sorted order; gsl_fit_linear's
    running means and centred moments in frame order (those of x, which
    depend on N alone, from ``_gsl_x_moments``); sigma as the sum of
    |residual| in frame order over N; line_clipping's left-to-right
    arithmetic, low before high; the flag scan that breaks once N - r <=
    4, r counted across passes; the removal that reads the positional
    buffer at every rank, stale flags past the break included; and the
    loop test n > 0 && N > 3. No multiply-add is fused, and every division
    is by a tensor on the device (CUDA divides by a host scalar through
    its reciprocal). Returns (mean uint16 (K,), rejlow int32 (K,), rejhigh
    int32 (K,)) on the columns' device: round_to_WORD of the survivors'
    mean."""
    f, k = columns.shape
    dev = columns.device
    siglow, sighigh = float(sig[0]), float(sig[1])
    if columns.dtype == torch.uint16:
        columns = u16_to_i32(columns)
    y = torch.sort(columns.to(torch.float64), dim=0).values
    rows = torch.arange(f, device=dev)[:, None]
    x = rows.to(torch.float64)
    inf = torch.full((1, 1), float("inf"), dtype=torch.float64, device=dev)
    moments = _gsl_x_moments(f, dev)
    n = torch.full((k,), f, dtype=torch.int64, device=dev)
    r = torch.zeros_like(n)
    rejl = torch.zeros(k, dtype=torch.int32, device=dev)
    rejh = torch.zeros_like(rejl)
    buf = torch.zeros((f, k), dtype=torch.int8, device=dev)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    it = 0
    # one host sync per pass: the loop runs until every column is done
    while it < MAX_ITERS and bool(active.any()):
        live = rows < n[None, :]
        # a dead row divides by inf: its step adds +-0 to the running mean
        den = torch.where(live, x + 1.0, inf)
        m_x, m_dx2 = moments[:, n - 1]
        m_y = torch.zeros(k, dtype=torch.float64, device=dev)
        for i in range(f):
            m_y = m_y + (y[i] - m_y) / den[i]
        dxdy = (x - m_x[None, :]) * (y - m_y[None, :])
        m_dxdy = torch.zeros_like(m_y)
        for i in range(f):
            m_dxdy = m_dxdy + (dxdy[i] - m_dxdy) / den[i]
        a = m_dxdy / m_dx2
        b = m_y - m_x * a
        ax = a[None, :] * x
        fit = ax + b[None, :]
        resid = torch.where(live, torch.abs(y - fit), 0.0)
        total = torch.zeros_like(m_y)
        for i in range(f):
            total = total + resid[i]
        sigma = (total / n.to(torch.float64))[None, :]
        low = ((fit - y) / sigma > siglow) & live
        high = (((y - ax) - b[None, :]) / sigma > sighigh) & live & ~low
        flag = low | high
        # the scan visits rank i unless N - r <= 4 held after an earlier one
        ends = live & (n[None, :] - (r[None, :] + torch.cumsum(flag, dim=0)) <= 4)
        seen = live & (torch.cumsum(ends, dim=0) - ends.to(torch.int64) == 0)
        buf_new = torch.where(seen, torch.where(low, -1, torch.where(high, 1, 0))
                              .to(torch.int8), buf)
        keep = live & (buf_new == 0)
        n_new = keep.sum(dim=0)
        # pack the survivors at the head of their column, in order
        to = torch.where(keep, torch.cumsum(keep, dim=0) - 1, f)
        packed = torch.zeros((f + 1, k), dtype=torch.float64, device=dev)
        packed.scatter_(0, to, y)
        y = torch.where(active[None, :], packed[:f], y)
        buf = torch.where(active[None, :], buf_new, buf)
        rejl = rejl + torch.where(active, (low & seen).sum(dim=0), 0).to(torch.int32)
        rejh = rejh + torch.where(active, (high & seen).sum(dim=0), 0).to(torch.int32)
        r = torch.where(active, r + (flag & seen).sum(dim=0), r)
        ended = active & ~((n_new < n) & (n_new > 3))
        n = torch.where(active, n_new, n)
        active = active & ~ended
        it += 1
    total = torch.where(rows < n[None, :], y, 0.0).sum(dim=0)
    mean = round_to_word_f(total / torch.clamp(n, min=1).to(torch.float64))
    mean = torch.where(n > 0, mean, 0.0)
    return i32_to_u16(mean.to(torch.int32)), rejl, rejh


def linearfit_exact(columns: np.ndarray, sig):
    """:func:`linearfit_settle` on every column of a (F, K) WORD-valued
    host array, on the CPU: the words and counters of the literal oracle
    (``verify.oracle.c_reject_block``). Returns NumPy ``(mean uint16 (K,),
    rejlow int32 (K,), rejhigh int32 (K,))``."""
    cols = torch.from_numpy(np.asarray(columns).astype(np.int32))
    mean, rejl, rejh = linearfit_settle(cols, sig)
    return u16_to_numpy(mean), rejl.numpy(), rejh.numpy()


__all__ = ["reject_and_mean", "reject_linearfit", "linearfit_exact",
           "linearfit_settle", "LINEARFIT_KNIFE_EPS",
           "reject_sigma", "reject_sigma_window",
           "reject_sigmedian", "reject_winsorized", "reject_winsorized_window",
           "reject_percentile", "reject_none", "masked_median", "MAX_ITERS"]
