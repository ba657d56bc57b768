"""Sigma-clip pixel rejection, vectorized over pixels — the plain PyTorch
version of the CUDA sigma kernel and the exact fix-up for its degenerate
pixels.

Port of the sigma subset of ``siriltpu.ops.rejection``. Reference:
src/stacking/stacking.c:1148-1160 (clip predicate) and :1674-1694 (the
per-pixel loop). Semantics frozen, as in the JAX package:

- the per-pixel cross-frame vector is sorted, then iteratively clipped
  around the GSL sorted-median using the GSL SAMPLE standard deviation
  (N-1 denominator, gsl_stats_ushort_sd);
- loops run while any pixel was rejected and more than 3 survive;
- flagging stops early within a pass once ``N - r <= 4`` where ``r``
  accumulates across passes (stacking.c:1684-1688). Positions after the
  break keep *stale* flags in the reused ``rejected[]`` buffer, and the
  removal loop consumes them without counting them (see _stale_pass);
- final pixel = round_to_WORD(mean of survivors) (:1790-1794).

Every statistic is computed as in the JAX package, down to the order of
the float32 operations, because the f32 sigma decides which values are
clipped: integer sums are exact, and only the final combine is f32.

Shapes: ``vals`` is (F, P) — F frames, P pixels. Values are WORD-valued
(uint16, int32 or integer-valued float32).
"""

from __future__ import annotations

import torch

from siriltpu_torch.ops.sortnet import sort_axis0
from siriltpu_torch.utils.interop import i32_to_u16, to_float32, u16_to_i32

Tensor = torch.Tensor

# Safety bound only: the reference loops are data-terminating (every pass
# removes >= 1 element). A 128-frame golden vector takes 61 passes, so the
# bound must stay well above F.
MAX_ITERS = 512

# rejections of siriltpu that are not ported yet (ROADMAP.md Queue 1 item 2)
_NOT_PORTED = (None, "none", "percentile", "sigmedian", "winsorized",
               "linearfit")


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
    nf = n.to(torch.float32)
    cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    anchor = torch.floor(_kth_valid(vals, cum, n // 2, valid)).to(torch.int32)
    vi = torch.where(valid, vals, 0.0).to(torch.int32)
    d = torch.where(valid, vi - anchor[None, :], 0)
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


def reject_sigma_window(vals: Tensor, siglow: float, sighigh: float,
                        presorted: bool = False):
    """SIGMA rejection, window formulation — the plain version of the CUDA
    sigma kernel.

    On the sorted pixel vector, sigma clipping removes a PREFIX (low
    rejects) and a SUFFIX (high rejects), so the survivors are a window
    [lo, hi). Statistics use the same exact integer sums as _gsl_sd, here
    centred on the lower middle order statistic, and the mean is exact
    integer round-half-up.

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
        nf = n.to(torch.float32)
        mask = (iota >= lo[None, :]) & (iota < hi[None, :])
        k1 = lo + (n - 1) // 2
        k2 = lo + n // 2
        v1 = torch.gather(svi, 0, k1[None, :].long())[0]
        v2 = torch.gather(svi, 0, k2[None, :].long())[0]
        median = 0.5 * (v1 + v2).to(torch.float32)
        # exact-integer sigma (see _gsl_sd): centre on the low median
        d = torch.where(mask, svi - v1[None, :], 0)
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
        sigma = torch.where(n > 1, torch.sqrt(torch.clamp(var, min=0.0)), 0.0)
        return n, mask, median, sigma

    z = torch.zeros(p, dtype=torch.int32, device=dev)
    lo, hi, r, rejl, rejh = z, torch.full_like(z, f), z, z, z
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    degen = torch.zeros_like(done)
    it = 0
    # one host sync per pass: the loop runs until every pixel is done
    while it < MAX_ITERS and not bool(done.all()):
        n, mask, median, sigma = win_stats(lo, hi)
        low = mask & (median[None, :] - svf > sl * sigma[None, :])
        high = mask & (svf - median[None, :] > sh * sigma[None, :])
        nlow = low.sum(dim=0).to(torch.int32)
        nhigh = high.sum(dim=0).to(torch.int32)
        # the C scan breaks iff n - (r + c) <= 4 for some prefix count c
        # (max c = nlow + nhigh), incl. c == 0 when n - r <= 4 already
        removed = nlow + nhigh
        hits_break = (n - r - removed) <= 4
        upd = ~done & ~hits_break
        lo = torch.where(upd, lo + nlow, lo)
        hi = torch.where(upd, hi - nhigh, hi)
        rejl = rejl + torch.where(upd, nlow, 0)
        rejh = rejh + torch.where(upd, nhigh, 0)
        r = torch.where(upd, r + removed, r)
        degen = degen | (~done & hits_break)
        done = done | hits_break | (removed == 0) | ((hi - lo) <= 3)
        it += 1
    # exact integer mean of the surviving window
    mask = (iota >= lo[None, :]) & (iota < hi[None, :])
    n = hi - lo
    s = torch.where(mask, svi, 0).sum(dim=0)
    mean = torch.where(n > 0, (2 * s + n) // torch.clamp(2 * n, min=1), 0)
    return i32_to_u16(mean.clamp(0, 65535)), rejl, rejh, degen


def reject_and_mean(vals: Tensor, rejection: str, sig=(3.0, 3.0)):
    """Full rejection + mean for a (F, P) block of WORD-valued pixels.

    Returns (uint16 mean (P,), rejlow (P,), rejhigh (P,)).

    ``sigma`` is a HYBRID: the window formulation handles every pixel,
    and the rare pixels that hit the reference's degenerate mid-scan
    break are re-run through the reference-exact masked formulation.
    ``sigma_masked`` runs the masked loop for everything. The other
    rejections are not ported yet and raise NotImplementedError."""
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
    if rejection == "sigma_masked":
        valid, v, rejl, rejh = reject_sigma(to_float32(vals), siglow, sighigh)
        return _mean_of_survivors(v, valid), rejl, rejh
    if rejection in _NOT_PORTED:
        raise NotImplementedError(
            f"rejection {rejection!r} is not ported to siriltpu_torch yet "
            "(ROADMAP.md Queue 1 item 2)")
    raise ValueError(f"unknown rejection {rejection!r}")


__all__ = ["reject_and_mean", "reject_sigma", "reject_sigma_window",
           "MAX_ITERS"]
