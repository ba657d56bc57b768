"""Star-pattern matching: triangle similarity voting + iterated linear
transform, re-derived as an array program.

Port of ``siriltpu.registration.matching``, which is NumPy already:
copied from it, so identical inputs give identical outputs.

Reference: src/registration/matching/ (SDSS "match" heritage):
``new_star_match`` (match.c:125-389) drives atFindTrans (triangle vote,
atpmatch.c:201-231) → atApplyTrans → atMatchLists → atRecalcTrans
(iterated least squares) → RANSAC homography. The reference's 5.8k-line
pointer implementation is deliberately NOT translated; this module
reimplements the algorithm on arrays with the same constants
(atpmatch.h): triangle-space radius 0.002 (:40), match radius 5.0 px
(:49), N brightest = 20 (:70), max recalc iterations 3 (:120),
sigma-clip percentile 0.70 (:106), min pairs 10 (:176).

Geometry: triangles from the N brightest stars; sides sorted a >= b >= c;
a triangle maps to (b/a, c/a) in "triangle space"; similar triangles vote
for their vertex correspondences (vertices ordered by opposite-side
length). The top-voted pairs seed a 6-parameter linear transform
x' = A + Bx + Cy, y' = D + Ex + Fy, refined by matching the full lists
and re-fitting.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Optional, Tuple

import numpy as np

AT_TRIANGLE_RADIUS = 0.002
AT_MATCH_RADIUS = 5.0
AT_MATCH_NBRIGHT = 20
AT_MATCH_MAXITER = 3
AT_MATCH_MINPAIRS = 10


@dataclass
class Trans:
    """Linear TRANS: x' = a + b*x + c*y ; y' = d + e*x + f*y."""
    a: float = 0.0
    b: float = 1.0
    c: float = 0.0
    d: float = 0.0
    e: float = 0.0
    f: float = 1.0

    def apply(self, xy: np.ndarray) -> np.ndarray:
        x, y = xy[:, 0], xy[:, 1]
        return np.stack([self.a + self.b * x + self.c * y,
                         self.d + self.e * x + self.f * y], axis=1)


def _triangles(xy: np.ndarray):
    """All triangles of a point set: returns (ratios (T,2), verts (T,3))
    with verts ordered (opposite longest, middle, shortest side)."""
    n = xy.shape[0]
    tri = np.array(list(combinations(range(n), 3)), dtype=np.int64)
    if tri.size == 0:
        return np.zeros((0, 2)), np.zeros((0, 3), dtype=np.int64)
    p0, p1, p2 = xy[tri[:, 0]], xy[tri[:, 1]], xy[tri[:, 2]]
    # side opposite vertex k
    s0 = np.linalg.norm(p1 - p2, axis=1)
    s1 = np.linalg.norm(p0 - p2, axis=1)
    s2 = np.linalg.norm(p0 - p1, axis=1)
    sides = np.stack([s0, s1, s2], axis=1)
    order = np.argsort(-sides, axis=1)  # descending: a >= b >= c
    srt = np.take_along_axis(sides, order, axis=1)
    verts = np.take_along_axis(tri, order, axis=1)
    a, b, c = srt[:, 0], srt[:, 1], srt[:, 2]
    good = (a > 0) & (c > 0)
    ratios = np.stack([np.where(a > 0, b / np.maximum(a, 1e-30), 0.0),
                       np.where(a > 0, c / np.maximum(a, 1e-30), 0.0)],
                      axis=1)
    return ratios[good], verts[good]


def vote_pairs(xy_a: np.ndarray, xy_b: np.ndarray,
               radius: float = AT_TRIANGLE_RADIUS
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle-space vote matrix; returns (pairs (k,2) [ia, ib], votes)."""
    ra, va = _triangles(xy_a)
    rb, vb = _triangles(xy_b)
    na, nb = xy_a.shape[0], xy_b.shape[0]
    votes = np.zeros((na, nb), dtype=np.int64)
    if ra.shape[0] == 0 or rb.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64), votes
    # pairwise distances in triangle space (T_a x T_b) — N=20 gives 1140
    # triangles/list, a 1140^2 boolean matrix, trivially small
    d2 = ((ra[:, None, :] - rb[None, :, :]) ** 2).sum(axis=2)
    ta, tb = np.nonzero(d2 < radius * radius)
    for k in range(3):
        np.add.at(votes, (va[ta, k], vb[tb, k]), 1)
    # greedy unique assignment by decreasing votes
    pairs = []
    v = votes.copy()
    while True:
        idx = np.unravel_index(np.argmax(v), v.shape)
        if v[idx] <= 0:
            break
        pairs.append(idx)
        v[idx[0], :] = -1
        v[:, idx[1]] = -1
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2), votes


def fit_trans(src: np.ndarray, dst: np.ndarray) -> Optional[Trans]:
    """Least-squares linear TRANS mapping src -> dst (atRecalcTrans's
    order-1 solve)."""
    n = src.shape[0]
    if n < 3:
        return None
    M = np.column_stack([np.ones(n), src[:, 0], src[:, 1]])
    try:
        cx, *_ = np.linalg.lstsq(M, dst[:, 0], rcond=None)
        cy, *_ = np.linalg.lstsq(M, dst[:, 1], rcond=None)
    except np.linalg.LinAlgError:
        return None
    return Trans(a=cx[0], b=cx[1], c=cx[2], d=cy[0], e=cy[1], f=cy[2])


def match_lists(xy_a: np.ndarray, xy_b: np.ndarray, trans: Trans,
                radius: float = AT_MATCH_RADIUS
                ) -> Tuple[np.ndarray, np.ndarray]:
    """atMatchLists: transform list A, pair each with the nearest B point
    within radius (unique, closest-first)."""
    ta = trans.apply(xy_a)
    d2 = ((ta[:, None, :] - xy_b[None, :, :]) ** 2).sum(axis=2)
    r2 = radius * radius
    pairs = []
    used_b = set()
    order = np.argsort(d2.min(axis=1))
    for ia in order:
        ib = int(np.argmin(d2[ia]))
        if d2[ia, ib] <= r2 and ib not in used_b:
            pairs.append((ia, ib))
            used_b.add(ib)
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(pairs, dtype=np.int64)
    return arr[:, 0], arr[:, 1]


def new_star_match(stars_img, stars_ref, nbright: int = AT_MATCH_NBRIGHT,
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, Trans]]:
    """Full matcher (match.c:125-389): triangle vote on the N
    brightest → initial TRANS → iterated full-list match + refit.

    ``stars_*`` are (n, 2) position arrays sorted brightest-first (or
    Star lists). Returns (matched_img_xy, matched_ref_xy, trans) or None.
    """
    xy_i = _as_xy(stars_img)
    xy_r = _as_xy(stars_ref)
    if xy_i.shape[0] < AT_MATCH_MINPAIRS or xy_r.shape[0] < AT_MATCH_MINPAIRS:
        return None
    nb = min(nbright, xy_i.shape[0], xy_r.shape[0])
    pairs, votes = vote_pairs(xy_i[:nb], xy_r[:nb])
    if pairs.shape[0] < 3:
        return None
    # keep top-voted half (>= 3) as the seed, like atFindTrans's vote cut
    k = max(3, pairs.shape[0] // 2)
    seed = pairs[:k]
    trans = fit_trans(xy_i[seed[:, 0]], xy_r[seed[:, 1]])
    if trans is None:
        return None
    for _ in range(AT_MATCH_MAXITER):
        ia, ib = match_lists(xy_i, xy_r, trans)
        if ia.size < AT_MATCH_MINPAIRS:
            return None
        new_trans = fit_trans(xy_i[ia], xy_r[ib])
        if new_trans is None:
            break
        trans = new_trans
    ia, ib = match_lists(xy_i, xy_r, trans)
    if ia.size < AT_MATCH_MINPAIRS:
        return None
    return xy_i[ia], xy_r[ib], trans


def _as_xy(stars) -> np.ndarray:
    if isinstance(stars, np.ndarray):
        return np.asarray(stars, dtype=np.float64).reshape(-1, 2)
    return np.array([[s.xpos, s.ypos] for s in stars], dtype=np.float64)


__all__ = ["new_star_match", "vote_pairs", "fit_trans", "match_lists",
           "Trans", "AT_MATCH_MINPAIRS", "AT_MATCH_NBRIGHT",
           "AT_MATCH_RADIUS", "AT_TRIANGLE_RADIUS"]
