"""The verdict of a run: each number compared beside its limit. A number
passes at or under its limit; ``correct`` is every number passing."""

from __future__ import annotations

import numpy as np


def largest_gap(got, want, relative: bool) -> float:
    """The largest |got - want| (over |want| where ``relative``) over the
    entries; NaN against NaN is no gap, NaN against a number an infinite
    one."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    gap = np.abs(got - want)
    if relative:
        gap = gap / np.maximum(np.abs(want), 1e-300)
    both = np.isnan(got) & np.isnan(want)
    gap = np.where(both, 0.0, np.where(np.isnan(gap), np.inf, gap))
    return float(gap.max()) if gap.size else 0.0


def words_off(got, want) -> int:
    """Integer output words that differ from the reference's: the stacked
    image's (``[0]``) and the shift table's (``[1]``), entry by entry."""
    n = 0
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        a, b = np.asarray(a), np.asarray(b)
        n += int(np.count_nonzero(a != b)) if a.shape == b.shape else max(a.size, b.size, 1)
    return n


def rows_off(a, b) -> int:
    """Rows that differ between two (N, k) tables, such as shifts."""
    return int(np.count_nonzero((np.asarray(a) != np.asarray(b)).any(axis=1)))


def verdict(numbers: dict, limits: dict):
    """(correct, [[name, number, limit], ...]) in the order of ``limits``;
    a number the limits do not name, or a limit with no number, fails."""
    rows = [[k, numbers.get(k), v] for k, v in limits.items()]
    rows += [[k, v, None] for k, v in numbers.items() if k not in limits]
    ok = all(n is not None and lim is not None and n <= lim for _, n, lim in rows)
    return ok, rows


__all__ = ["largest_gap", "words_off", "rows_off", "verdict"]
