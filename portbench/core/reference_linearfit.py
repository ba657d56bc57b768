"""The plain reference of linear-fit clipping (stacking.c:1750-1783): what
Siril's LINEARFIT rejection makes of each pixel's column, in plain PyTorch,
with nothing of the program under test imported.

Each pass over a pixel's survivors, in sorted order: ``gsl_fit_linear``
of the values against their ranks 0 .. N-1 (GSL fit/linear.c: running
means of x and y, then running means of dx * dx and dx * dy, each step
``m += (t - m) / (i + 1)``, in rank order), sigma the sum of the absolute
residuals in rank order over N, then ``line_clipping``, low before high:
``(a * i + b - x) / sigma > siglow`` and ``(x - a * i - b) / sigma >
sighigh``, left to right. The flag scan, its break once N - r <= 4 and
the stale flags that the removal reads past it are ``reference.py``'s
(``_stale_pass``); the loop goes on while a pass removed a value and more
than 3 survive. The mean of the survivors is rounded to a word.

The survivors stay in place under a mask; each recurrence walks the
frame slots in order and steps a pixel where its slot survives. Pixels
that finish leave the loop (``_retire``), so a pass costs what the pixels
still running cost.

Siril computes the fit in double. The fit is the ``ikss`` stage of a
``Precision``, the one stage that ``Precision()`` computes in float64 and
that a stack without normalization does not otherwise use: each result
of the fit's arithmetic is rounded to that stage's type, so that
``Precision.below`` of a configuration that states ``ikss`` float64 runs
the fit in float32.
"""

from __future__ import annotations

import torch

from portbench.core.frames import u16_to_i32
from portbench.core.reference import (MAX_ITERS, Precision, _mean_of_survivors,
                                      _retire, _stale_pass)

STAGE = "ikss"


def _fit(x, valid, rank, prec: Precision):
    """gsl_fit_linear of each pixel's surviving values ``x`` against their
    ranks: (slope, intercept), float64 (P,)."""
    p = x.shape[1]

    def step(m, t, i):
        return prec.round(STAGE, m + prec.round(STAGE, prec.round(STAGE, t - m) / (i + 1.0)))

    zero = torch.zeros(p, dtype=torch.float64, device=x.device)
    m_x, m_y = zero, zero
    for j in range(x.shape[0]):
        m_x = torch.where(valid[j], step(m_x, rank[j], rank[j]), m_x)
        m_y = torch.where(valid[j], step(m_y, x[j], rank[j]), m_y)
    m_dx2, m_dxdy = zero, zero
    for j in range(x.shape[0]):
        dx = prec.round(STAGE, rank[j] - m_x)
        dy = prec.round(STAGE, x[j] - m_y)
        m_dx2 = torch.where(valid[j], step(m_dx2, prec.round(STAGE, dx * dx), rank[j]), m_dx2)
        m_dxdy = torch.where(valid[j], step(m_dxdy, prec.round(STAGE, dx * dy), rank[j]),
                             m_dxdy)
    slope = prec.round(STAGE, m_dxdy / m_dx2)
    return slope, prec.round(STAGE, m_y - prec.round(STAGE, m_x * slope))


def reject_linearfit(vals: torch.Tensor, siglow: float, sighigh: float,
                     prec: Precision):
    """Linear-fit clipping of (F, P) uint16 values: (mean uint16, rejl,
    rejh)."""
    f, p = vals.shape
    dev = vals.device
    sv = torch.sort(u16_to_i32(vals), dim=0).values.to(torch.float64)
    out = (torch.ones((f, p), dtype=torch.bool, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev),
           torch.zeros(p, dtype=torch.int32, device=dev))
    idx = torch.arange(p, device=dev)
    valid, rejl, rejh = out[0].clone(), out[1].clone(), out[2].clone()
    r = torch.zeros(p, dtype=torch.int32, device=dev)
    buf = torch.zeros((f, p), dtype=torch.int8, device=dev)
    x = sv
    it = 0
    while idx.numel() and it < MAX_ITERS:
        n = valid.sum(dim=0).to(torch.int32)
        rank = (torch.cumsum(valid, dim=0) - 1).to(torch.float64)
        a, b = _fit(x, valid, rank, prec)
        ai = prec.round(STAGE, a[None, :] * rank)
        line = prec.round(STAGE, ai + b[None, :])
        resid = prec.round(STAGE, torch.abs(prec.round(STAGE, x - line)))
        total = torch.zeros_like(a)
        for j in range(f):
            total = torch.where(valid[j], prec.round(STAGE, total + resid[j]), total)
        sigma = prec.round(STAGE, total / n.to(torch.float64))[None, :]
        low = (prec.round(STAGE, prec.round(STAGE, line - x) / sigma) > siglow) & valid
        high = (prec.round(STAGE, prec.round(STAGE, prec.round(STAGE, x - ai) - b[None, :])
                           / sigma) > sighigh) & valid & ~low
        valid, buf, r, removed, cnt_l, cnt_h = _stale_pass(valid, buf, r, low, high, n)
        rejl, rejh = rejl + cnt_l, rejh + cnt_h
        done = (removed == 0) | (n - removed <= 3)
        idx, valid, rejl, rejh, x, buf, r = _retire(
            done, idx, out, valid, rejl, rejh, x, buf, r)
        it += 1
    _retire(torch.ones_like(idx, dtype=torch.bool), idx, out, valid, rejl, rejh)
    valid, rejl, rejh = out
    return _mean_of_survivors(sv, valid), rejl, rejh


def stack(flat: torch.Tensor, sig, prec: Precision, block_values: int = 1 << 25):
    """Linear-fit rejection mean of (F, P) uint16 values in blocks of
    pixels: (P,) uint16, and the total low and high rejections."""
    f, p = flat.shape
    step = max(1, block_values // f)
    out = torch.empty(p, dtype=torch.int16, device=flat.device)
    low = high = 0
    for a in range(0, p, step):
        mean, rl, rh = reject_linearfit(flat[:, a:a + step], float(sig[0]),
                                        float(sig[1]), prec)
        out[a:a + step] = mean.view(torch.int16)
        low += int(rl.sum())
        high += int(rh.sum())
    return out.view(torch.uint16), low, high


__all__ = ["reject_linearfit", "stack", "STAGE"]
