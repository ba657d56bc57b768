"""Global star registration of siriltpu_torch against siriltpu and the
compiled reference: ``registration/matching.py``, ``registration/ransac.py``,
``ops/warp.py`` and ``registration/global_star.py``.

Both packages get the same seeded NumPy inputs (star frames here are one
shape, 160 x 192, so that JAX compiles its star finder once). Tolerances:

- matching and RANSAC are the same NumPy code with the same seeded
  generator: tolerance 0 (pairs, votes, transforms, H and inlier mask);
  the goldens at the JAX tests' own tolerances (c_match: the same
  correspondences but 2; c_homography: transfer error 1e-4 px exact,
  0.5 px noisy);
- the warp samples by gather in the JAX package's order of float32
  operations, but XLA on the CPU contracts ``H[0,0]*x + H[0,1]*y +
  H[0,2]``, the kernel polynomials and the tap sums into fused
  multiply-adds, which the port's separate torch ops do not (the port does
  not reproduce the contraction). Source coordinates then differ in the
  last unit: a nearest sample on a .5 boundary takes the neighbouring
  pixel, so nearest words differ on at most 1e-4 of the pixels; every
  other interpolation is held within 1 LSB on at most 0.1% of the words,
  against JAX's gather sampler and against its tiled sampler alike. The
  port's own entry points (``warp_frame_bu``, ``warp_frame_dev``,
  ``warp_layer_dev``, ``warp_batch_dev``) are equal bit for bit; the
  c_cvgeom envelope at the JAX test's tolerance;
- ``register_global_star`` end to end: the same frames registered and
  failed; the star finders agree within 2e-3 px (test_torch_starfind.py,
  their f32 LM sums are ordered differently), so the homographies within
  1e-3 (4e-4 seen) and the mean FWHMs of the ``.seq`` within 1e-4
  relative (3e-5 seen). A homography 4e-4 apart moves a sample by as much
  on a star whose slope reaches ~9000 counts a pixel, so the aligned words
  of the two packages are held within 3 LSB, with at most 5% of them
  differing (2 LSB and 2.2% seen); with JAX's homography the port's warp
  gives JAX's words within 1 LSB on at most 0.5% (0.05% seen), and the
  ``r_`` frames equal the port's own warp of the input bit for bit. The
  sigma stack of four such frames is held within 2 LSB on at most 5% of
  the pixels (1-2 LSB and 1.6% seen): two frames 2 LSB apart the same way
  move their mean by 1-2 LSB, so 1 LSB does not hold. Everything else in
  the ``.seq`` (shifts, selection, geometry) is equal.

The ``cuda`` cases at the end hold the card against the CPU: the warp bit
for bit for nearest, linear, cubic and area, within 1 LSB for lanczos4
(``sin`` differs in the last unit between the CPU and CUDA).
"""

import glob
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import seqfile as tseqfile  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.io import ser as tser  # noqa: E402
from siriltpu_torch.ops import starfind as tsf  # noqa: E402
from siriltpu_torch.ops import warp as tw  # noqa: E402
from siriltpu_torch.registration import global_star as tg  # noqa: E402
from siriltpu_torch.registration import matching as tm  # noqa: E402
from siriltpu_torch.registration import ransac as tr  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402
from siriltpu_torch.utils import timing  # noqa: E402

#: one frame shape for every star-finder case, so that JAX compiles once
FH, FW = 160, 192
INTERPS = (tw.INTER_NEAREST, tw.INTER_LINEAR, tw.INTER_CUBIC, tw.INTER_AREA,
           tw.INTER_LANCZOS4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference (not on a machine
    without JAX)."""
    pytest.importorskip("jax")
    from siriltpu.core import frame
    from siriltpu.io import fits, seqfile, sequence, ser
    from siriltpu.ops import warp
    from siriltpu.registration import global_star, matching, ransac
    from siriltpu.stacking import api
    return SimpleNamespace(frame=frame, fits=fits, seqfile=seqfile,
                           sequence=sequence, ser=ser, warp=warp,
                           global_star=global_star, matching=matching,
                           ransac=ransac, api=api)


def make_affine(angle_deg=0.0, scale=1.0, tx=0.0, ty=0.0):
    a = np.radians(angle_deg)
    return np.array([[scale * np.cos(a), -scale * np.sin(a), tx],
                     [scale * np.sin(a), scale * np.cos(a), ty],
                     [0, 0, 1.0]])


def apply_h(H, xy):
    ph = np.column_stack([xy, np.ones(len(xy))]) @ H.T
    return ph[:, :2] / ph[:, 2:3]


def words_close(got, want, lsb: int, frac: float, ctx=""):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= lsb, (ctx, d.max())
    assert (d != 0).mean() <= frac, (ctx, (d != 0).mean())


# ----------------------------------------------------------------- frames

def star_frame(stars: np.ndarray, seed: int, h: int = FH, w: int = FW,
               background: float = 900.0, noise: float = 6.0) -> np.ndarray:
    """(1, H, W) uint16 bottom-up frame: ``background`` + Gaussian noise +
    one A exp(-r^2 / (2 s)) per row (x, y, A, s) of ``stars`` (bottom-up
    coordinates)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w), background)
    for x0, y0, amp, s in stars:
        img += amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2.0 * s))
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(np.rint(img), 0, 65535).astype(np.uint16)[None]


#: top-down homographies frame -> reference (the JAX end-to-end test's)
TRANSFORMS = [make_affine(), make_affine(angle_deg=2.0, tx=4.0, ty=-3.0),
              make_affine(angle_deg=-1.5, tx=-6.0, ty=2.0),
              make_affine(angle_deg=0.5, tx=8.0, ty=5.0)]


def scene(transforms=TRANSFORMS, nstars: int = 25, seed: int = 67) -> np.ndarray:
    """(F, 1, H, W) frames of one star field, frame i seen through
    transforms[i]^-1 (star positions moved, not cropped)."""
    rng = np.random.default_rng(seed)
    base = np.column_stack([
        rng.uniform(25, FW - 25, nstars), rng.uniform(25, FH - 25, nstars),
        rng.uniform(8000, 30000, nstars), rng.uniform(4, 7, nstars)])
    frames = []
    for i, T in enumerate(transforms):
        td = apply_h(np.linalg.inv(T),
                     np.column_stack([base[:, 0], (FH - 1) - base[:, 1]]))
        st = base.copy()
        st[:, 0], st[:, 1] = td[:, 0], (FH - 1) - td[:, 1]
        frames.append(star_frame(st, seed + i))
    return np.stack(frames)


def warp_image(seed: int = 0, h: int = 192, w: int = 256) -> np.ndarray:
    """(H, W) uint16 star field at the density the word bounds were measured
    on (60 stars in 512 x 768): stars of up to 40000 counts on a sky of
    1000 with noise, whose steep slopes are where coordinates matter."""
    rng = np.random.default_rng(seed)
    n = max(4, h * w // 6500)
    stars = np.column_stack([rng.uniform(5, w - 5, n), rng.uniform(5, h - 5, n),
                             rng.uniform(2000, 40000, n), rng.uniform(2, 8, n)])
    return star_frame(stars, seed, h, w, background=1000.0, noise=10.0)[0]


#: config-4-like homography: 0.7 degrees, (4.3, -2.6) px, mild perspective
H_CONFIG4 = make_affine(angle_deg=0.7, tx=4.3, ty=-2.6)
H_CONFIG4[2, :2] = (2e-6, -1e-6)
#: word bounds against JAX: nearest (LSB, fraction), the others
NEAREST_FRAC = 1e-4
OTHER_FRAC = 1e-3


def jax_bounds(interp):
    """(max |diff|, max fraction of words differing) against JAX."""
    return (65535, NEAREST_FRAC) if interp == tw.INTER_NEAREST else (1, OTHER_FRAC)


# --------------------------------------------------------- matching, RANSAC

@pytest.fixture
def star_sets():
    rng = np.random.default_rng(60)
    ref = rng.uniform(20, 480, size=(40, 2))
    H = make_affine(angle_deg=4.0, scale=1.01, tx=12.3, ty=-7.7)
    # image stars = H^-1(ref): matching should recover H (img -> ref)
    img = apply_h(np.linalg.inv(H), ref)
    img += rng.normal(0, 0.05, img.shape)
    return img, ref, H


def variant(star_sets, name):
    """The fixture's lists and their variations: spurious faint stars and
    missing bright ones (the JAX test's), a short list, one too short."""
    img, ref, _ = star_sets
    rng = np.random.default_rng(62)
    if name == "extra":
        return (np.vstack([img[2:], rng.uniform(0, 500, size=(8, 2))]),
                np.vstack([ref, rng.uniform(0, 500, size=(6, 2))]))
    if name == "few":
        return img[:12], ref[:12]
    if name == "too_few":
        return img[:9], ref[:9]
    if name == "unrelated":
        return img, rng.uniform(0, 500, size=(40, 2))
    return img, ref


VARIANTS = ["plain", "extra", "few", "too_few", "unrelated"]


@pytest.mark.parametrize("name", VARIANTS)
def test_vote_pairs_fit_and_match_lists_match_jax(jx, star_sets, name):
    img, ref = variant(star_sets, name)
    nb = min(20, len(img), len(ref))
    pairs, votes = tm.vote_pairs(img[:nb], ref[:nb])
    jpairs, jvotes = jx.matching.vote_pairs(img[:nb], ref[:nb])
    np.testing.assert_array_equal(pairs, jpairs)
    np.testing.assert_array_equal(votes, jvotes)
    assert pairs.dtype == votes.dtype == np.int64
    for k in (2, 3, min(len(pairs), 8)):
        trans = tm.fit_trans(img[pairs[:k, 0]], ref[pairs[:k, 1]])
        jtrans = jx.matching.fit_trans(img[pairs[:k, 0]], ref[pairs[:k, 1]])
        if jtrans is None:
            assert trans is None
            continue
        assert vars(trans) == vars(jtrans)
        got = tm.match_lists(img, ref, trans)
        want = jx.matching.match_lists(img, ref, jtrans)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", VARIANTS)
def test_new_star_match_matches_jax(jx, star_sets, name):
    img, ref = variant(star_sets, name)
    got = tm.new_star_match(img, ref)
    want = jx.matching.new_star_match(img, ref)
    assert (got is None) == (want is None)
    if name in ("plain", "extra", "few"):
        assert got is not None
        mi, mr, trans = got
        assert np.median(np.hypot(*(apply_h(star_sets[2], mi) - mr).T)) < 0.5
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert vars(got[2]) == vars(want[2])
    # Star lists go in as well as positions
    stars = [tsf.Star(x, y, 0.0, 3.0, 3.0, 1.0, 0.0, 1.0, 1.0) for x, y in img]
    np.testing.assert_array_equal(tm._as_xy(stars), img)


@pytest.mark.parametrize("case", ["outliers", "exact", "matched", "short", "seed"])
def test_find_homography_matches_jax(jx, star_sets, case):
    rng = np.random.default_rng(64)
    seed = 0
    if case == "outliers":        # the JAX test's: 20 of 60 corrupted
        H = make_affine(angle_deg=-2.0, scale=0.98, tx=-4.0, ty=9.0)
        src = rng.uniform(0, 400, size=(60, 2))
        dst = apply_h(H, src)
        dst[:20] += rng.uniform(20, 80, size=(20, 2))
    elif case == "exact":
        H = np.array([[1.02, 0.03, 5.0], [-0.02, 0.99, -3.0], [1e-5, -2e-5, 1.0]])
        src = rng.uniform(0, 400, size=(12, 2))
        dst = apply_h(H, src)
    elif case == "short":
        src, dst = star_sets[0][:3], star_sets[1][:3]
    else:
        mi, mr, _ = tm.new_star_match(star_sets[0], star_sets[1])
        src, dst = mi, mr
        seed = 11 if case == "seed" else 0
    got = tr.find_homography(src, dst, seed=seed)
    want = jx.ransac.find_homography(src, dst, seed=seed)
    assert (got is None) == (want is None) == (case == "short")
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if case == "outliers":
            assert got[1].sum() >= 38 and not got[1][:20].any()
            np.testing.assert_allclose(got[0], H / H[2, 2], atol=1e-3)
    if case == "exact":
        Hs = tr.dlt_homography(src, dst)
        np.testing.assert_array_equal(Hs, jx.ransac.dlt_homography(src, dst))
        np.testing.assert_allclose(Hs, H, rtol=1e-6, atol=1e-6)


def test_star_match_vs_c():
    """c_match.bin with the assertions of the JAX test
    (tests/test_c_goldens.py:861): the same correspondences as the
    compiled atpmatch stack but 2, and as many pairs but 2."""
    from test_c_goldens import GOLDEN_DIR, Reader

    r = Reader(os.path.join(GOLDEN_DIR, "c_match.bin"))
    ncases = 0
    while not r.eof():
        n = r.take("H")
        r.take("dddd")                    # angle, scale, tx, ty
        A = np.array([[r.take("d"), r.take("d"), r.take("d")] for _ in range(n)])
        B = np.array([[r.take("d"), r.take("d"), r.take("d")] for _ in range(n)])
        m = r.take("i")
        cpairs = [(r.take("d"), r.take("d"), r.take("d"), r.take("d"))
                  for _ in range(m)]
        res = tm.new_star_match(A[:, :2], B[:, :2])
        assert res is not None, ncases
        gi, gr, _ = res
        ours = {(round(gi[k, 0], 9), round(gi[k, 1], 9)):
                (round(gr[k, 0], 9), round(gr[k, 1], 9)) for k in range(len(gi))}
        agree = sum(ours.get((round(ax, 9), round(ay, 9))) == (round(bx, 9), round(by, 9))
                    for ax, ay, bx, by in cpairs)
        assert agree >= m - 2, (ncases, agree, m, gi.shape[0])
        assert abs(gi.shape[0] - m) <= 2, (ncases, gi.shape[0], m)
        ncases += 1
    assert ncases == 3


def test_ransac_homography_vs_bundled_c():
    """c_homography.bin with the assertions of the JAX test
    (tests/test_c_goldens.py:1207): inliers within 10% of the bundled
    OpenCV-2 findHomography's, transfer error over its inliers 1e-4 px on
    exact fixtures and 0.5 px on noisy ones."""
    from test_c_goldens import _read_homography

    recs = _read_homography()
    assert len(recs) == 60
    for n, noise, outfrac, src, dst, ret, Hc, mask, inliers in recs:
        assert ret == 1
        res = tr.find_homography(src, dst)
        assert res is not None, (n, noise, outfrac)
        Ho, inl = res
        assert inl.sum() >= 0.9 * inliers, (n, noise, outfrac, int(inl.sum()))
        ph = np.column_stack([src[mask], np.ones(mask.sum())])
        proj_c = (ph @ Hc.T)[:, :2] / (ph @ Hc.T)[:, 2:3]
        proj_o = (ph @ Ho.T)[:, :2] / (ph @ Ho.T)[:, 2:3]
        terr = np.hypot(*(proj_o - proj_c).T).max()
        assert terr <= (1e-4 if noise == 0.0 else 0.5), (n, noise, outfrac, terr)


# -------------------------------------------------------------------- warp

def run_jax_warp(jx, img, Hinv, out_shape, interp):
    import jax.numpy as jnp
    return np.asarray(jx.warp.warp_perspective(
        jnp.asarray(img).astype(jnp.float32), jnp.asarray(Hinv, jnp.float32),
        out_shape, interp))


def run_port_warp(img, Hinv, out_shape, interp, device="cpu"):
    return tw.warp_perspective(
        torch.from_numpy(img.astype(np.int32)).to(device),
        torch.from_numpy(Hinv.astype(np.float32)).to(device), out_shape,
        interp).cpu().numpy()


def to_words(x):
    return np.clip(np.rint(x), 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("interp", INTERPS)
def test_warp_perspective_matches_jax_gather(jx, interp):
    """A 192 x 256 star field through a config-4-like homography, and
    through the identity (weights exact: the words equal the image)."""
    img = warp_image()
    Hinv = np.linalg.inv(H_CONFIG4)
    got = run_port_warp(img, Hinv, img.shape, interp)
    assert got.dtype == np.float32 and got.shape == img.shape
    want = run_jax_warp(jx, img, Hinv, img.shape, interp)
    words_close(to_words(got), to_words(want), *jax_bounds(interp), interp)
    same = run_port_warp(img, np.eye(3), img.shape, interp)
    np.testing.assert_array_equal(to_words(same), img)


@pytest.mark.parametrize("interp", INTERPS)
def test_warp_batch_dev_matches_jax_tiled(jx, interp):
    """Three layers and homographies through the port's gather batch warp
    and the JAX package's, which takes its tiled banded sampler here."""
    layers = np.stack([warp_image(s, 96, 160) for s in range(3)])
    Hs = np.stack([np.eye(3), make_affine(angle_deg=-0.4, tx=-3.3, ty=1.7),
                   H_CONFIG4])
    assert jx.warp._tiled_plan(np.linalg.inv(Hs), (96, 160), (96, 160),
                               interp) is not None
    got = interop.u16_to_numpy(tw.warp_batch_dev(layers, Hs, (96, 160), interp,
                                                 device="cpu"))
    want = np.asarray(jx.warp.warp_batch_dev(layers, Hs, (96, 160), interp))
    words_close(got, want, *jax_bounds(interp), interp)
    np.testing.assert_array_equal(got[0], layers[0])


@pytest.mark.parametrize("interp", INTERPS)
def test_warp_entry_points_agree(interp):
    """warp_frame_bu, warp_frame_dev, warp_layer_dev and warp_batch_dev are
    the same warp: bit-equal (tests/test_global_alignment.py:192-227);
    AREA is LINEAR in a warp."""
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 65535, (3, 48, 56)).astype(np.uint16)
    H = np.array([[1.001, 0.002, 1.5], [-0.003, 0.999, -2.25], [1e-6, -2e-6, 1.0]])
    host = tw.warp_frame_bu(frame, H, (40, 64), interp, device="cpu")
    assert host.dtype == np.uint16 and host.shape == (3, 40, 64)
    dev = interop.u16_to_numpy(tw.warp_frame_dev(
        interop.frames_from_numpy(frame, "cpu"), H, (40, 64), interp))
    np.testing.assert_array_equal(dev, host)
    for c in range(3):
        one = tw.warp_layer_dev(interop.frames_from_numpy(frame[c], "cpu"), H,
                                (40, 64), interp)
        np.testing.assert_array_equal(interop.u16_to_numpy(one), host[c])
    batch = tw.warp_batch_dev(frame, np.stack([H] * 3), (40, 64), interp,
                              device="cpu")
    np.testing.assert_array_equal(interop.u16_to_numpy(batch), host)
    if interp == tw.INTER_AREA:
        np.testing.assert_array_equal(host, tw.warp_frame_bu(
            frame, H, (40, 64), tw.INTER_LINEAR, device="cpu"))


def test_warp_translation_and_constants():
    """A whole-pixel translation moves the image (the JAX test's), a
    frame flips to top-down and back, the enum is OpenCV's, and a frames
    mesh (parallel/mesh.py) gives the unsharded words."""
    rng = np.random.default_rng(66)
    img = rng.integers(100, 50000, size=(1, 48, 56)).astype(np.uint16)
    H = np.array([[1, 0, 5.0], [0, 1, 3.0], [0, 0, 1.0]])
    out = tw.warp_frame_bu(img, H, (48, 56), tw.INTER_LINEAR, device="cpu")
    np.testing.assert_array_equal(out[0][::-1][10:40, 10:50],
                                  img[0][::-1][7:37, 5:45])
    assert (tw.INTER_NEAREST, tw.INTER_LINEAR, tw.INTER_CUBIC, tw.INTER_AREA,
            tw.INTER_LANCZOS4) == (0, 1, 2, 3, 4)
    with pytest.raises(ValueError, match="unknown interpolation"):
        tw.warp_frame_bu(img, H, (48, 56), 7, device="cpu")
    from siriltpu_torch.parallel.mesh import make_mesh
    pair = np.concatenate([img, img[:, ::-1]])
    Hs = np.stack([H, H])
    np.testing.assert_array_equal(
        interop.u16_to_numpy(tw.warp_batch_dev(pair, Hs, (48, 56), device="cpu",
                                               mesh=make_mesh(devices=["cpu"] * 3))),
        interop.u16_to_numpy(tw.warp_batch_dev(pair, Hs, (48, 56), device="cpu")))
    with pytest.raises(TypeError):
        tw.warp_frame_bu(img, H, (48, 56))      # no device


@pytest.mark.parametrize("interp", INTERPS)
def test_wild_warp_matches_jax_gather(jx, interp):
    """A 30 degree rotation has no tiled plan: JAX's warp_frame_bu takes its
    gather sampler, as the port always does. A homography that sends every
    pixel far outside the image (coordinates past int32) gives zeros in
    both, whatever the device does with an out-of-range cast."""
    img = warp_image(1, 96, 128)[None]
    H = make_affine(angle_deg=30.0, tx=20.0, ty=-10.0)
    assert jx.warp._tiled_plan(np.linalg.inv(H), (2048, 3072), (2048, 3072),
                               interp) is None
    got = tw.warp_frame_bu(img, H, (96, 128), interp, device="cpu")
    want = jx.warp.warp_frame_bu(img, H, (96, 128), interp)
    words_close(got, want, *jax_bounds(interp), interp)
    # source x from 3e9 up (past int32), source y from -3e9 to -2e9
    far = np.linalg.inv(np.array([[1e7, 0, 3e9], [0, 1e7, -3e9], [0, 0, 1.0]]))
    got = tw.warp_frame_bu(img, far, (96, 128), interp, device="cpu")
    np.testing.assert_array_equal(got, jx.warp.warp_frame_bu(img, far, (96, 128), interp))
    assert not got.any()


def test_production_warp_within_quantization_envelope():
    """c_cvgeom.bin's warpPerspective records at the JAX test's tolerance
    (tests/test_cv_goldens.py:200): nearest equal to the real OpenCV, the
    others within 5% of the local range at most and 2% on average."""
    from test_cv_goldens import RECS

    checked = 0
    for op, interp, params, inp, want in RECS:
        if op != 1:
            continue
        Hinv = np.linalg.inv(params.reshape(3, 3))
        got = to_words(run_port_warp(inp, Hinv, want.shape, interp)).astype(float)
        d = np.abs(got - want.astype(float))
        rng_local = float(inp.max()) - float(inp.min())
        if interp == 0:
            assert d.max() == 0
        else:
            assert d.max() <= 0.05 * rng_local, (interp, d.max())
            assert d.mean() <= 0.02 * rng_local
        checked += 1
    assert checked >= 5


# ------------------------------------------------------ global registration

def write_fits_dir(directory, frames):
    for i, fr in enumerate(frames):
        tfits.write_fits(os.path.join(directory, f"ds{i + 1:03d}.fit"),
                         tframe.Frame(fr))


def write_ser(path, frames):
    ser = tser.SerFile.create(path, FW, FH)
    for fr in frames:
        ser.write_frame(tframe.Frame(fr))
    ser.write_and_close()


def open_seq(pkg, kind, directory):
    if kind == "ser":
        return pkg.ser_sequence(os.path.join(directory, "film.ser"))
    return pkg.check_seq(directory)[0]


@pytest.fixture(scope="module", params=["fits", "ser"])
def e2e(request, jx, tmp_path_factory):
    """The scene written once as FITS files or one SER file into a
    directory per package; each package registers its copy
    (``register_global_star``, output written) and then stacks the ``r_``
    sequence (mean, sigma (3, 3))."""
    kind = request.param
    frames = scene()
    runs = {}
    for name, seqmod, reg, dev in (
            ("jax", jx.sequence, jx.global_star.register_global_star, {}),
            ("torch", tsequence, tg.register_global_star, {"device": "cpu"})):
        d = str(tmp_path_factory.mktemp(f"{kind}_{name}"))
        if kind == "ser":
            write_ser(os.path.join(d, "film.ser"), frames)
        else:
            write_fits_dir(d, frames)
        seq = open_seq(seqmod, kind, d)
        out = []
        report = reg(seq, 0, output_frames=out, **dev)
        rseq = [s for s in seqmod.check_seq(d) if s.seqname.startswith("r_")]
        runs[name] = SimpleNamespace(dir=d, seq=seq, report=report, out=out,
                                     rseq=rseq)
    return SimpleNamespace(kind=kind, frames=frames, **runs)


def test_register_global_star_counts_and_homographies(e2e):
    t, j = e2e.torch.report, e2e.jax.report
    assert (t.registered, t.failed) == (j.registered, j.failed) == (4, 0)
    assert t.new_seqname == j.new_seqname
    for i, T in enumerate(TRANSFORMS):
        np.testing.assert_allclose(t.homographies[i], j.homographies[i], atol=1e-3)
        np.testing.assert_allclose(t.homographies[i], T, atol=0.08)
    np.testing.assert_array_equal(t.homographies[0], np.eye(3))
    np.testing.assert_allclose(t.fwhm, j.fwhm, rtol=1e-4)


def test_register_global_star_output_frames(e2e):
    """The r_ files: same names and geometry; their frames equal the
    port's in-memory output and the port's own warp of the input, and
    JAX's within the bounds of the docstring."""
    t, j = e2e.torch, e2e.jax
    assert len(t.rseq) == len(j.rseq) == 1
    rt, rj = t.rseq[0], j.rseq[0]
    assert (rt.seqname, rt.seqtype, rt.number, rt.rx, rt.ry, rt.nb_layers) == \
        (rj.seqname, rj.seqtype, rj.number, rj.rx, rj.ry, rj.nb_layers)
    if e2e.kind == "fits":
        names = sorted(os.path.basename(p) for p in glob.glob(f"{t.dir}/r_*"))
        assert names == sorted(os.path.basename(p) for p in glob.glob(f"{j.dir}/r_*"))
    for i in range(4):
        got, want = rt.read_frame(i).data, rj.read_frame(i).data
        np.testing.assert_array_equal(got, t.out[i].data)
        H = t.report.homographies[i]
        np.testing.assert_array_equal(got, tw.warp_frame_bu(
            e2e.frames[i], H, (FH, FW), device="cpu") if i else e2e.frames[i])
        words_close(got, want, 3, 0.05, i)
        if i:
            jh = tw.warp_frame_bu(e2e.frames[i], j.report.homographies[i],
                                  (FH, FW), device="cpu")
            words_close(jh, want, 1, 0.005, i)


def test_register_global_star_seqfile_and_stack(e2e, jx):
    """The r_ .seq reads back with the same state in both packages, and the
    sigma stack of the r_ sequence is within 1 LSB of JAX's."""
    t, j = e2e.torch, e2e.jax
    name = e2e.torch.report.new_seqname + ".seq"
    ft = interop.sequence_to_fields(tseqfile.read_seqfile(os.path.join(t.dir, name)))
    fj = interop.sequence_to_fields(jx.seqfile.read_seqfile(os.path.join(j.dir, name)))
    for k in interop.SEQUENCE_SCALARS:
        if k != "seq_dir":
            assert ft[k] == fj[k], k
    np.testing.assert_array_equal(ft["filenum"], fj["filenum"])
    np.testing.assert_array_equal(ft["incl"], fj["incl"])
    fwhm = interop.REG_COLUMNS.index("fwhm")
    for layer in fj["reg"]:
        a, b = ft["reg"][layer], fj["reg"][layer]
        np.testing.assert_allclose(a[:, fwhm], b[:, fwhm], rtol=1e-4)
        np.testing.assert_array_equal(np.delete(a, fwhm, 1), np.delete(b, fwhm, 1))
    got = tapi.stack_sequence(t.rseq[0], device="cpu", method="mean",
                              rejection="sigma", sig=(3.0, 3.0))
    want = jx.api.stack_sequence(j.rseq[0], method="mean", rejection="sigma",
                                 sig=(3.0, 3.0))
    words_close(got.data, want.data, 2, 0.05)
    assert got.data.max() > 0.8 * e2e.frames[0].max()
    assert t.seq.needs_saving and j.seq.needs_saving


def test_register_global_translation_only_matches_jax(jx, tmp_path):
    """translation_only: shiftx = round(h02), shifty = round(-h12) equal in
    both packages; no r_ output."""
    shifts = [(0, 0), (5, -3), (-4, 2), (2, 6)]
    frames = scene([make_affine(tx=-tx, ty=ty) for tx, ty in shifts])
    seqs = []
    for name, seqmod, reg, kw in (
            ("jax", jx.sequence, jx.global_star.register_global_star, {}),
            ("torch", tsequence, tg.register_global_star, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        write_fits_dir(str(d), frames)
        seq = seqmod.check_seq(str(d))[0]
        rep = reg(seq, 0, translation_only=True, **kw)
        assert rep.failed == 0 and rep.registered == 4
        assert not glob.glob(f"{d}/r_*")
        seqs.append((seq, rep))
    (jseq, jrep), (tseq, trep) = seqs
    np.testing.assert_array_equal(tseq.reg_shifts(0), jseq.reg_shifts(0))
    for i, (tx, ty) in enumerate(shifts):
        H = trep.homographies[i]
        assert abs(H[0, 2] + tx) < 0.5 and abs(H[1, 2] - ty) < 0.5
        assert tuple(tseq.reg_shifts(0)[i]) == (int(round(H[0, 2])),
                                                int(round(-H[1, 2])))


def test_register_global_included_frames_and_batch_match_jax(jx):
    """process_all_frames=False skips an excluded frame in both packages;
    global_align_batch gives JAX's homographies and, within the port,
    register_global_star's pixels (tests/test_global_alignment.py:230)."""
    frames = scene()
    jseq = jx.sequence.internal_sequence([jx.frame.Frame(f) for f in frames])
    tseq = tsequence.internal_sequence([tframe.Frame(f) for f in frames])
    outs = {}
    for name, seq, reg, kw in (
            ("jax", jseq, jx.global_star.register_global_star, {}),
            ("torch", tseq, tg.register_global_star, {"device": "cpu"})):
        seq.set_included(2, False)
        outs[name] = []
        rep = reg(seq, 0, process_all_frames=False, write_output=False,
                  output_frames=outs[name], **kw)
        assert (rep.registered, rep.failed, len(rep.homographies)) == (3, 0, 3)
        outs[name + "_rep"] = rep
    for a, b in zip(outs["torch_rep"].homographies, outs["jax_rep"].homographies):
        np.testing.assert_allclose(a, b, atol=1e-3)
    assert not tseq.imgparam[2].incl and tseq.needs_saving

    layers = frames[:, 0]
    aligned, rep = tg.global_align_batch(layers, 0, device="cpu", nmax=2048)
    _, jrep = jx.global_star.global_align_batch(layers, 0, nmax=2048)
    assert (rep.registered, rep.failed) == (jrep.registered, jrep.failed) == (4, 0)
    assert aligned.dtype == np.uint16 and aligned.shape == layers.shape
    out = []
    tseq.set_included(2, True)
    loop = tg.register_global_star(tseq, 0, device="cpu", write_output=False,
                                   output_frames=out, chunk_frames=3)
    for i in range(4):
        np.testing.assert_allclose(rep.homographies[i], jrep.homographies[i], atol=1e-3)
        np.testing.assert_array_equal(rep.homographies[i], loop.homographies[i])
        np.testing.assert_array_equal(aligned[i], out[i].data[0])
    # over a frames mesh (parallel/mesh.py): the same bits
    from siriltpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=["cpu"] * 3)
    sharded, srep = tg.global_align_batch(layers, 0, device="cpu", nmax=2048,
                                          mesh=mesh)
    np.testing.assert_array_equal(sharded, aligned)
    out_mesh = []
    tg.register_global_star(tseq, 0, device="cpu", write_output=False,
                            output_frames=out_mesh, mesh=mesh)
    for i in range(4):
        np.testing.assert_array_equal(srep.homographies[i], rep.homographies[i])
        np.testing.assert_array_equal(out_mesh[i].data, out[i].data)


def test_register_global_star_rgb_in_memory():
    """Colour frames: stars found on the chosen layer, every layer warped
    by the frame's homography; the reference frame passes through."""
    frames = scene()
    rgb = np.concatenate([frames, (frames * 0.8).astype(np.uint16),
                          (frames * 0.6).astype(np.uint16)], axis=1)
    seq = tsequence.internal_sequence([tframe.Frame(f) for f in rgb])
    out = []
    timing.enable()
    try:
        rep = tg.register_global_star(seq, 1, device="cpu", write_output=False,
                                      output_frames=out)
    finally:
        timing.disable()
    spans = timing.collect()
    assert rep.registered == 4 and len(seq.regparam[1]) == 4
    np.testing.assert_array_equal(out[0].data, rgb[0])
    for i in range(1, 4):
        assert out[i].data.shape == (3, FH, FW)
        np.testing.assert_array_equal(out[i].data, tw.warp_frame_bu(
            rgb[i], rep.homographies[i], (FH, FW), device="cpu"))
    # the stages' spans; the reads on the loader thread
    assert set(timing.totals(spans)) == {
        "global.read", "global.wait", "global.starfind", "global.match",
        "global.warp", "global.copy", "global.write"}
    main = {s.thread for s in spans if s.name == "global.match"}
    assert all(s.thread not in main for s in spans if s.name == "global.read")


def test_register_global_star_error_cleanup(tmp_path, monkeypatch):
    """If the consume loop dies mid-sequence the loader thread does not stay
    blocked on the full queue, and the partly written output SER is closed
    with a consistent header (tests/test_global_alignment.py:303)."""
    frames = scene()
    write_ser(str(tmp_path / "film.ser"), frames)
    seq = tsequence.check_seq(str(tmp_path))[0]

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tsf, "peaker_batch", boom)
    n0 = threading.active_count()
    with pytest.raises(RuntimeError, match="device lost"):
        tg.register_global_star(seq, 0, device="cpu", chunk_frames=1)
    for _ in range(50):
        if threading.active_count() <= n0:
            break
        time.sleep(0.1)
    assert threading.active_count() <= n0
    assert tser.SerFile.open(str(tmp_path / "r_film.ser")).frame_count == 0


def test_register_global_read_error_surfaces(tmp_path):
    """A frame-read failure in the loader thread surfaces as an exception
    in the caller (tests/test_global_alignment.py:597)."""
    write_fits_dir(str(tmp_path), scene()[:3])
    seq = tsequence.check_seq(str(tmp_path))[0]
    seq.read_frame(0)
    os.truncate(str(tmp_path / "ds003.fit"), 100)
    with pytest.raises(Exception):
        tg.register_global_star(seq, 0, device="cpu", write_output=False)
    with pytest.raises(ValueError, match="not enough stars"):
        tg.register_global_star(tsequence.internal_sequence(
            [tframe.Frame(np.full((1, FH, FW), 900, np.uint16))] * 2), 0,
            device="cpu")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp is checked on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("interp", INTERPS)
def test_cuda_warp_matches_cpu(cuda_device, interp):
    """The card's warp words equal the CPU's for nearest, linear, cubic and
    area (separate torch ops, no contraction); lanczos4 within 1 LSB."""
    layers = np.stack([warp_image(s, 192, 256) for s in range(2)])
    Hs = np.stack([H_CONFIG4, make_affine(angle_deg=-0.4, tx=-3.3, ty=1.7)])
    got = interop.u16_to_numpy(tw.warp_batch_dev(layers, Hs, (192, 256), interp,
                                                 device=cuda_device))
    want = interop.u16_to_numpy(tw.warp_batch_dev(layers, Hs, (192, 256), interp,
                                                  device="cpu"))
    if interp == tw.INTER_LANCZOS4:
        words_close(got, want, 1, 1.0, interp)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_global_align_batch_matches_cpu(cuda_device):
    """global_align_batch on the card against the CPU: the same frames
    registered, homographies within 1e-3 (the star fits' f32 sums differ),
    and the aligned words within the end-to-end bounds."""
    layers = scene()[:, 0]
    got, grep = tg.global_align_batch(layers, 0, device=cuda_device)
    want, wrep = tg.global_align_batch(layers, 0, device="cpu")
    assert (grep.registered, grep.failed) == (wrep.registered, wrep.failed) == (4, 0)
    for a, b in zip(grep.homographies, wrep.homographies):
        np.testing.assert_allclose(a, b, atol=1e-3)
    words_close(got, want, 3, 0.05)
