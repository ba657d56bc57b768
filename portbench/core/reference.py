"""The plain reference of register + stack: what Siril's semantics make of
a sequence, in plain PyTorch and NumPy, with nothing of the program under
test imported.

- Registration (registration.c:182-400): phase correlation of each
  frame's square selection against frame 0's, in float64; the argmax of
  the correlation surface, first in row-major order, decoded to (shiftx,
  shifty) with values past half the side wrapped to negative.
- Quality (quality.c:46-218, QUALTYPE_NORMAL): the exact float64 NumPy
  estimate; only the subsample factor 3 has a nonzero weight.
- Alignment: a whole-pixel shift with zero fill,
  out(y, x) = frame(y - shifty, x - shiftx).
- Normalization (stacking.c:79-123, 1635-1651): IKSS location and scale
  of every frame from its value histogram (statistics.c:152-187, float64),
  the additive coefficients, applied to each value in float32 as the
  program states it, rounded to a word; rows shifted in first (their zero
  fill normalized too), columns after (their fill stays 0).
- Rejection (stacking.c:1656-1794): the masked formulation of the
  per-pixel loops, Siril's stale-buffer quirks included: the sorted
  column, the GSL median and sample standard deviation (exact integer
  sums, one float32 combine), sigma clipping, and winsorized clipping
  with its fixed point; the mean of the survivors rounded to a word.

Every float stage takes a ``Precision``. The reference runs at
``Precision()``: float64 where Siril computes in double (the correlation,
the quality, the IKSS statistics), float32 where the repository's frozen
semantics state it (the rejection's sigma combine, the normalization of
each value). The control, ``Precision.below(stated)``, runs each stage one
step below the precision the configuration states for the program's path,
float64 -> float32 -> bfloat16, by rounding the stage's results to it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.core.frames import to_u16, u16_to_i32

_LOWER = {"float64": "float32", "float32": "bfloat16"}
_TORCH = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}

# a safety bound only: every pass of the loops removes a value or ends
MAX_ITERS = 512
# invalid slots of the winsorized working copy sort above every value
_INVALID = 1e9
THRESHOLD = 40 << 8
MAXP_CAP = 65530
QMARGIN = 0.1


@dataclass(frozen=True)
class Precision:
    """The type each float stage computes in: ``correlation`` (the phase
    correlation), ``quality``, ``statistics`` (the rejection's median and
    sigma), ``ikss`` (normalization statistics) and ``normalize`` (the
    coefficients applied to the values)."""

    correlation: str = "float64"
    quality: str = "float64"
    statistics: str = "float32"
    ikss: str = "float64"
    normalize: str = "float32"

    @classmethod
    def below(cls, stated: dict) -> "Precision":
        """The control's: each stage one step below ``stated[stage]``."""
        return cls(**{k: _LOWER[v] for k, v in stated.items()})

    def round(self, stage: str, x):
        """``x`` (a float tensor or array) rounded to the stage's type where
        that is narrower than x's own."""
        name = getattr(self, stage)
        if isinstance(x, np.ndarray):
            if name == "float64":
                return x
            t = torch.from_numpy(np.array(x, dtype=np.float64).reshape(-1))
            return t.to(_TORCH[name]).to(torch.float64).numpy().reshape(x.shape)
        if name == "float64" or (name == "float32" and x.dtype in (
                torch.float32, torch.complex64)):
            return x
        if x.is_complex():
            return torch.complex(self.round(stage, x.real), self.round(stage, x.imag))
        return x.to(_TORCH[name]).to(x.dtype)


# ------------------------------------------------------------ registration

def phase_shifts(frames: torch.Tensor, sel, prec: Precision, chunk: int = 64):
    """(F, 2) int32 (shiftx, shifty) of every frame against frame 0 over the
    square selection sel = (x0, y0, side) of (F, H, W) uint16 frames."""
    x0, y0, s = sel
    sels = frames[:, y0:y0 + s, x0:x0 + s]

    def spectrum(v):
        return prec.round("correlation", torch.fft.rfft2(
            prec.round("correlation", u16_to_i32(v).to(torch.float64))))

    ref = spectrum(sels[0:1])
    out = []
    for a in range(0, sels.shape[0], chunk):
        cross = prec.round("correlation", ref * torch.conj(spectrum(sels[a:a + chunk])))
        corr = prec.round("correlation", torch.fft.irfft2(cross, s=(s, s)))
        idx = torch.argmax(corr.reshape(corr.shape[0], -1), dim=1)
        sy, sx = idx // s, idx % s
        sy = torch.where(sy > s // 2, sy - s, sy)
        sx = torch.where(sx > s // 2, sx - s, sx)
        out.append(torch.stack([sx, sy], dim=1))
    shifts = torch.cat(out).cpu().numpy().astype(np.int32)
    shifts[0] = 0
    return shifts


def quality(layer: np.ndarray, prec: Precision) -> float:
    """QualityEstimate (QUALTYPE_NORMAL) of one uint16 layer: sqrt of the
    gradient energy of the subsample-3 image, NaN where no pixel passes
    the threshold."""
    h, w = layer.shape
    s = 3
    xs, ys = (w - 1) // s, (h - 1) // s
    if xs < 2 or ys < 2:
        return 0.0
    a = layer[:ys * s, :xs * s].astype(np.int64)
    buf = a.reshape(ys, s, xs, s).sum(axis=(1, 3)) // (s * s)
    # the stretch: the running maximum of middle-row samples below 65530
    # (quality.c:101-137, whose MAXP insert loop degenerates to it)
    mid = buf[1:ys - 1]
    cand = mid[(mid > 0) & (mid < MAXP_CAP)]
    mx = int(cand.max()) if cand.size else 0
    if mx > 0:
        v = prec.round("quality", buf.astype(np.float64) * prec.round(
            "quality", np.array(60000.0 / mx)))
        buf = np.minimum(v.astype(np.uint64), 65535).astype(np.int64)
    # 3x3 integer-mean smooth, borders zero (quality.c:332-349)
    sm = np.zeros_like(buf)
    sm[1:-1, 1:-1] = (buf[:-2, :-2] + buf[:-2, 1:-1] + buf[:-2, 2:]
                      + buf[1:-1, :-2] + buf[1:-1, 1:-1] + buf[1:-1, 2:]
                      + buf[2:, :-2] + buf[2:, 1:-1] + buf[2:, 2:]) // 9
    # the gradient energy over the 3x3 dilation of the bright pixels
    yb, xb = int(ys * QMARGIN) + 1, int(xs * QMARGIN) + 1
    if yb >= ys - yb or xb >= xs - xb:
        return float("nan")
    interior = np.zeros((ys, xs), dtype=bool)
    interior[yb:ys - yb, xb:xs - xb] = True
    sig = (sm >= THRESHOLD) & interior
    if not sig.any():
        return float("nan")
    m = np.zeros((ys + 2, xs + 2), dtype=bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            m[dy:dy + ys, dx:dx + xs] |= sig
    mask = m[1:1 + ys, 1:1 + xs] & interior
    b = sm.astype(np.float64)
    d1 = b - np.roll(b, -1, axis=1)
    d2 = b - np.roll(b, -1, axis=0)
    energy = prec.round("quality", (d1 * d1 + d2 * d2)[mask])
    val = prec.round("quality", np.array(energy.sum() / int(mask.sum()) / 10.0))
    return float(np.sqrt(val).item())


def qualities(frames: torch.Tensor, sel, prec: Precision) -> np.ndarray:
    x0, y0, s = sel
    host = frames[:, y0:y0 + s, x0:x0 + s].contiguous().view(torch.int16)
    host = host.cpu().numpy().view(np.uint16)
    return np.array([quality(layer, prec) for layer in host])


def normalize_quality(q: np.ndarray) -> np.ndarray:
    """(q - min) / (max - min), NaN ignored (registration.c:163-176)."""
    qmin, qmax = np.nanmin(q), np.nanmax(q)
    if qmax == qmin:
        return np.zeros_like(q)
    return (q - qmin) / (qmax - qmin)


def align(frames: torch.Tensor, shifts: np.ndarray) -> torch.Tensor:
    """out[f, y, x] = frames[f, y - shifty, x - shiftx], 0 outside."""
    f, h, w = frames.shape
    dev = frames.device
    sx = torch.from_numpy(shifts[:, 0].astype(np.int64)).to(dev)
    sy = torch.from_numpy(shifts[:, 1].astype(np.int64)).to(dev)
    rows = torch.arange(h, device=dev)[None, :] - sy[:, None]
    cols = torch.arange(w, device=dev)[None, :] - sx[:, None]
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    g = frames.view(torch.int16)[torch.arange(f, device=dev)[:, None, None],
                                 rows.clamp(0, h - 1)[:, :, None],
                                 cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside, g, 0).view(torch.uint16)


# ----------------------------------------------------------- normalization

def _sorted_median(values: np.ndarray, weights: np.ndarray, n: int) -> float:
    """GSL median of a sorted multiset given as values and their counts."""
    csum = np.cumsum(weights)
    if n % 2 == 1:
        return float(values[np.searchsorted(csum, (n - 1) // 2, side="right")])
    v1 = values[np.searchsorted(csum, n // 2 - 1, side="right")]
    v2 = values[np.searchsorted(csum, n // 2, side="right")]
    return float((v1 + v2) / 2.0)


def ikss(counts: np.ndarray, norm: float, prec: Precision):
    """IKSS location and scale (statistics.c:152-187) of a value histogram,
    in [0, norm]. Works on the occupied bins only."""
    occupied = np.nonzero(counts)[0]
    v = occupied.astype(np.float64) / norm
    c = counts[occupied].astype(np.float64)
    lo, hi, s0 = 0.0, 1.0, 1.0
    while True:
        active = np.where((v >= lo) & (v <= hi), c, 0.0)
        n = int(active.sum())
        if n < 1:
            return 0.0, 0.0
        m = _sorted_median(v, active, n)
        deltas = np.abs(v - m)
        order = np.argsort(deltas, kind="stable")
        mad = _sorted_median(deltas[order], active[order], n)
        bwmv = 0.0
        if mad > 0.0:
            yi = prec.round("ikss", (v - m) / (9.0 * mad))
            yi2 = yi * yi
            ai = (np.abs(yi) < 1.0).astype(np.float64)
            up = prec.round("ikss", active * ai * (v - m) ** 2 * (1.0 - yi2) ** 4).sum()
            down = prec.round("ikss", active * ai * (1.0 - yi2) * (1.0 - 5.0 * yi2)).sum()
            if down != 0.0:
                bwmv = n * (up / (down * down))
        s = float(np.sqrt(bwmv))
        if s < 2e-23:
            return m * norm, 0.0
        if (s0 - s) / s < 10e-6:
            return m * norm, 0.991 * s * norm
        s0 = s
        lo, hi = max(lo, m - 4.0 * s), min(hi, m + 4.0 * s)


def additive_coefficients(frames: torch.Tensor, mode: str, prec: Precision):
    """(offset, scale) float64 (F,) of the additive normalizations against
    frame 0 (stacking.c:79-123)."""
    f = frames.shape[0]
    stats = []
    for i in range(f):
        counts = torch.bincount(u16_to_i32(frames[i]).reshape(-1),
                                minlength=65536).cpu().numpy()
        norm = 255 if not counts[256:].any() else 65535
        stats.append(ikss(counts[:norm + 1], float(norm), prec))
    loc = np.array([s[0] for s in stats])
    sc = np.array([s[1] for s in stats])
    scale = np.ones(f)
    if mode == "additive_scaling":
        scale = np.where(sc != 0, sc[0] / np.where(sc != 0, sc, 1.0), 1.0)
    elif mode != "additive":
        raise ValueError(f"no reference for normalization {mode!r}")
    return scale * loc - loc[0], scale


def round_word(x: torch.Tensor) -> torch.Tensor:
    """round_to_WORD keeping the float type: 0 at or below 0, 65535 above
    it, else floor(x + 0.5)."""
    out = torch.floor(x + 0.5)
    out = torch.where(x <= 0.0, 0.0, out)
    return torch.where(x > 65535.0, 65535.0, out)


def normalized_flat(frames: torch.Tensor, shifts: np.ndarray, mode: str,
                    prec: Precision) -> torch.Tensor:
    """The (F, H * W) uint16 values a normalized mean stack combines: rows
    shifted with zero fill, every value normalized (the row fill too),
    columns shifted with zero fill."""
    f = frames.shape[0]
    dev = frames.device
    zero = np.zeros_like(shifts)
    rows = align(frames, np.stack([zero[:, 0], shifts[:, 1]], axis=1))
    if mode != "none":
        offset, scale = additive_coefficients(frames, mode, prec)
        off = torch.tensor(offset, dtype=torch.float32, device=dev)[:, None, None]
        sc = torch.tensor(scale, dtype=torch.float32, device=dev)[:, None, None]
        x = u16_to_i32(rows).to(torch.float32)
        x = round_word(prec.round("normalize", prec.round("normalize", x * sc) - off))
        rows = to_u16(x)
    return align(rows, np.stack([shifts[:, 0], zero[:, 1]], axis=1)).reshape(f, -1)


# --------------------------------------------------------------- rejection

def _kth_valid(vals, cum, k, valid):
    hit = (cum == (k[None, :] + 1)) & valid
    return torch.where(hit, vals, 0.0).sum(dim=0)


def _median(vals, valid, n, prec):
    """GSL sorted median over the valid values."""
    cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    v1 = _kth_valid(vals, cum, (n - 1) // 2, valid)
    v2 = _kth_valid(vals, cum, n // 2, valid)
    return prec.round("statistics", torch.where(n > 0, 0.5 * (v1 + v2), 0.0))


def _sd_of_deviations(d, n, prec):
    """Sample sd (N - 1) from int32 deviations: exact integer sums of an
    8-bit split of |d|, then one float32 combine."""
    nf = n.to(torch.float32)
    s1 = d.sum(dim=0)
    ad = d.abs()
    hi8, lo8 = ad >> 8, ad & 255
    s2 = ((hi8 * hi8).sum(dim=0).to(torch.float32) * 65536.0
          + (hi8 * lo8).sum(dim=0).to(torch.float32) * 512.0
          + (lo8 * lo8).sum(dim=0).to(torch.float32))
    s1f = s1.to(torch.float32)
    var = prec.round("statistics", (s2 - s1f * s1f / torch.clamp(nf, min=1.0))
                     / torch.clamp(nf - 1.0, min=1.0))
    return prec.round("statistics", torch.where(
        n > 1, torch.sqrt(torch.clamp(var, min=0.0)), 0.0))


def _sd(vals, valid, n, prec):
    """gsl_stats_ushort_sd of the valid values, centred on the upper middle
    order statistic."""
    cum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    anchor = torch.floor(_kth_valid(vals, cum, n // 2, valid)).to(torch.int32)
    vi = torch.where(valid, vals, 0.0).to(torch.int32)
    return _sd_of_deviations(torch.where(valid, vi - anchor[None, :], 0), n, prec)


def _mean_of_survivors(vals, valid):
    """round_to_WORD(sum / n) in exact integers. uint16."""
    n = valid.sum(dim=0).to(torch.int32)
    s = torch.where(valid, vals, 0.0).to(torch.int32).sum(dim=0)
    m = torch.where(n > 0, (2 * s + n) // torch.clamp(2 * n, min=1), 0)
    return to_u16(m.clamp(0, 65535))


def _stale_pass(valid, buf, r_prev, low, high, n):
    """One flag and removal pass with the C's quirks (stacking.c:1674-1694):
    the flag scan writes a positional buffer and stops once N - r <= 4;
    the removal reads the buffer at every rank, so ranks past the break
    keep the previous pass's flags and remove values uncounted."""
    f = valid.shape[0]
    fresh = low | high
    c = torch.cumsum(fresh, dim=0, dtype=torch.int32)
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
    idx = torch.where(valid, rank, f).long()
    buf_ext = torch.cat([buf, torch.zeros_like(buf[:1])])
    buf_ext.scatter_(0, idx, torch.where(valid, entry, 0).to(torch.int8))
    return (valid & ~remove, buf_ext[:f], r_new,
            remove.sum(dim=0).to(torch.int32), cnt_l, cnt_h)


def _retire(done, idx, out, *arrays):
    """Write the finished pixels' entries of ``arrays`` (each (P,) or (F, P)
    over the running pixels ``idx``) into the first ``len(out)`` arrays
    ``out`` (over all pixels), and return ``idx`` and ``arrays`` cut to the
    pixels still running."""
    d = torch.nonzero(done)[:, 0]
    for o, a in zip(out, arrays):
        o[..., idx[d]] = a[..., d]
    keep = torch.nonzero(~done)[:, 0]
    return (idx[keep],) + tuple(a[..., keep] for a in arrays)


def _clip_loop(sv, centre_and_sigma, siglow, sighigh, prec, extra=()):
    """The shared outer loop of sigma and winsorized clipping: flag around
    the centre by sigma, remove, until a pass removes nothing or at most 3
    values survive. Pixels that finish leave the loop (their state is
    frozen there, as the per-pixel loops freeze it), so a pass costs what
    the pixels still running cost. ``extra`` are (P,) arrays that travel
    with the pixels into ``centre_and_sigma(x, valid, n, *extra)``.
    Returns (valid, rejl, rejh)."""
    f, p = sv.shape
    dev = sv.device
    sl = torch.tensor(siglow, dtype=torch.float32, device=dev)
    sh = torch.tensor(sighigh, dtype=torch.float32, device=dev)
    out = (torch.ones((f, p), dtype=torch.bool, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev))
    idx = torch.arange(p, device=dev)
    valid, rejl, rejh = out[0].clone(), out[1].clone(), out[2].clone()
    r = torch.zeros(p, dtype=torch.int32, device=dev)
    buf = torch.zeros((f, p), dtype=torch.int8, device=dev)
    x, extra = sv, tuple(extra)
    it = 0
    while idx.numel() and it < MAX_ITERS:
        n = valid.sum(dim=0).to(torch.int32)
        median, sigma = centre_and_sigma(x, valid, n, *extra)
        low = (median[None, :] - x > prec.round("statistics", sl * sigma)[None, :]) & valid
        high = (x - median[None, :] > prec.round("statistics", sh * sigma)[None, :]) & valid
        valid, buf, r, removed, cnt_l, cnt_h = _stale_pass(valid, buf, r, low, high, n)
        rejl, rejh = rejl + cnt_l, rejh + cnt_h
        done = (removed == 0) | (n - removed <= 3)
        idx, valid, rejl, rejh, x, buf, r, *extra = _retire(
            done, idx, out, valid, rejl, rejh, x, buf, r, *extra)
        it += 1
    _retire(torch.ones_like(idx, dtype=torch.bool), idx, out, valid, rejl, rejh)
    return out


def reject_sigma(vals: torch.Tensor, siglow: float, sighigh: float,
                 prec: Precision):
    """Sigma clipping of (F, P) uint16 values: (mean uint16, rejl, rejh)."""
    sv = torch.sort(u16_to_i32(vals), dim=0).values.to(torch.float32)
    valid, rejl, rejh = _clip_loop(
        sv, lambda x, valid, n: (_median(x, valid, n, prec), _sd(x, valid, n, prec)),
        siglow, sighigh, prec)
    return _mean_of_survivors(sv, valid), rejl, rejh


def reject_winsorized(vals: torch.Tensor, siglow: float, sighigh: float,
                      prec: Precision):
    """Winsorized sigma clipping (stacking.c:1710-1748) of (F, P) uint16
    values: each pass winsorizes the survivors (clamp to median -+ 1.5
    sigma, re-measure the median and 1.134 sd) until sigma moves by at
    most 5e-4 of itself, then clips the unclamped values with that median
    and sigma. Statistics are centred on the middle order statistic.
    Returns (mean uint16, rejl, rejh)."""
    f, p = vals.shape
    dev = vals.device
    sv_orig = torch.sort(u16_to_i32(vals), dim=0).values.to(torch.float32)
    anchor = torch.floor(sv_orig[f // 2])

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    c15, c1134, tiny, tol = f32(1.5), f32(1.134), f32(1e-30), f32(0.0005)

    def converge(x, valid, n, lo, hi):
        """The winsorized fixed point of each pixel, clamped values rounded
        into [lo, hi]: (median, sigma)."""
        sig = _sd(x, valid, n, prec)
        med = _median(x, valid, n, prec)
        out = (med.clone(), sig.clone())
        idx = torch.arange(x.shape[1], device=dev)
        w = torch.where(valid, x, _INVALID)

        def round_shift(t):
            r = torch.floor(t + 0.5)
            r = torch.where(t <= lo, lo, r)
            return torch.where(t > hi, hi, r)

        it = 0
        while idx.numel() and it < MAX_ITERS:
            m0 = prec.round("statistics", med - prec.round("statistics", c15 * sig))
            m1 = prec.round("statistics", med + prec.round("statistics", c15 * sig))
            clamped = torch.where(w < m0[None, :], round_shift(m0)[None, :],
                                  torch.where(w > m1[None, :],
                                              round_shift(m1)[None, :], w))
            w = torch.where(w < _INVALID / 2, clamped, w)
            wvalid = w < _INVALID / 2
            med_new = _median(w, wvalid, n, prec)
            sig_new = prec.round("statistics", c1134 * _sd(w, wvalid, n, prec))
            done = (sig <= 0) | (
                torch.abs(sig_new - sig) / torch.maximum(sig, tiny) <= tol)
            idx, med, sig, w, n, lo, hi = _retire(
                done, idx, out, med_new, sig_new, w, n, lo, hi)
            it += 1
        _retire(torch.ones_like(idx, dtype=torch.bool), idx, out, med, sig)
        return out

    valid, rejl, rejh = _clip_loop(sv_orig - anchor[None, :], converge, siglow,
                                   sighigh, prec, extra=(-anchor, 65535.0 - anchor))
    return _mean_of_survivors(sv_orig, valid), rejl, rejh


REJECTIONS = {"sigma": reject_sigma, "winsorized": reject_winsorized}


def stack(flat: torch.Tensor, rejection: str, sig, prec: Precision,
          block_values: int = 1 << 26):
    """Rejection mean of (F, P) uint16 values in blocks of pixels: (P,)
    uint16, and the total low and high rejections."""
    f, p = flat.shape
    fn = REJECTIONS[rejection]
    step = max(1, block_values // f)
    out = torch.empty(p, dtype=torch.int16, device=flat.device)
    low = high = 0
    for a in range(0, p, step):
        mean, rl, rh = fn(flat[:, a:a + step], float(sig[0]), float(sig[1]), prec)
        out[a:a + step] = mean.view(torch.int16)
        low += int(rl.sum())
        high += int(rh.sum())
    return out.view(torch.uint16), low, high


__all__ = ["Precision", "phase_shifts", "qualities", "quality",
           "normalize_quality", "align", "normalized_flat", "stack",
           "additive_coefficients", "ikss"]
