"""The star pipeline of siriltpu_torch against siriltpu and the compiled
reference C: ``ops/wavelets.py``, ``ops/psf.py``, ``ops/photometry.py``,
``ops/starfind.py``, ``registration/onestar.py``,
``core/memory.py:starfind_chunk_frames`` and the star and PSF carriers of
``utils/interop.py``.

Both packages get the same seeded NumPy inputs. Tolerances:

- wavelets: the linear kernel's taps are powers of two, so its planes are
  held at tolerance 0. The B-spline kernel's are not (6/16), and XLA on the
  CPU contracts ``out + w * shifted`` into a fused multiply-add, which
  rounds once where the port's separate product and sum round twice: the
  planes are held within 0.02 (two units in the last place of 65535; the
  golden allows 0.5) and the extracted words within 1 LSB on under 1% of
  the pixels, as the golden does;
- PSF: the 3x3 neighbour median and the initial parameters at tolerance
  0; the LM fit, whose normal equations are f32 sums over the box that the
  two packages order differently, within 2e-3 px in position, 2e-3
  relative in sx, sy and the FWHMs, 1e-3 in A, B, rmse and mag (2e-4 was
  seen), against the golden's own 0.02 px / 1.5% (tests/test_c_goldens.py);
- photometry is the same NumPy code: tolerance 0 against siriltpu, the
  golden at its own tolerances;
- star lists: the same stars in the same order, positions within 2e-3 px
  and magnitudes within 1e-3 of siriltpu's, since they come from the fit;
  the peak mask and the candidate selection are held at tolerance 0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from siriltpu.core import frame as jframe  # noqa: E402
from siriltpu.core import memory as jmemory  # noqa: E402
from siriltpu.io import sequence as jsequence  # noqa: E402
from siriltpu.ops import photometry as jphot  # noqa: E402
from siriltpu.ops import psf as jpsf  # noqa: E402
from siriltpu.ops import starfind as jsf  # noqa: E402
from siriltpu.ops import wavelets as jwav  # noqa: E402
from siriltpu.registration import onestar as jone  # noqa: E402
from siriltpu.testing.synth import gaussian_star, starfield  # noqa: E402
from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.core import memory as tmemory  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.ops import photometry as tphot  # noqa: E402
from siriltpu_torch.ops import psf as tpsf  # noqa: E402
from siriltpu_torch.ops import starfind as tsf  # noqa: E402
from siriltpu_torch.ops import wavelets as twav  # noqa: E402
from siriltpu_torch.registration import onestar as tone  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

from test_c_goldens import GOLDEN_DIR, Reader  # noqa: E402

#: one frame shape for every star-finder case, so that JAX compiles once
FH, FW = 160, 192


def as_i32(a: np.ndarray):
    return torch.from_numpy(a.astype(np.int32))


def word_close(got, want, ctx):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1, (ctx, d.max())
    assert (d != 0).mean() < 0.01, (ctx, (d != 0).mean())


# ---------------------------------------------------------------- wavelets

@pytest.mark.parametrize("nplanes", [3, 5])
@pytest.mark.parametrize("kind", [twav.TO_PAVE_LINEAR, twav.TO_PAVE_BSPLINE])
def test_atrous_transform_matches_jax(kind, nplanes):
    img = np.random.default_rng(kind + nplanes).integers(
        0, 65536, (70, 90)).astype(np.uint16)
    want = np.asarray(jwav.atrous_transform(jnp.asarray(img), nplanes, kind))
    got = twav.atrous_transform(as_i32(img), nplanes, kind).numpy()
    assert got.shape == (nplanes, 70, 90) and got.dtype == np.float32
    atol = 0.0 if kind == twav.TO_PAVE_LINEAR else 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the planes sum back to the image
    np.testing.assert_allclose(got.sum(axis=0), img, atol=0.05)
    for plane in range(nplanes):
        word_close(twav.wavelet_plane_word(img, nplanes, plane, kind,
                                           device="cpu"),
                   jwav.wavelet_plane_word(img, nplanes, plane, kind),
                   (kind, plane))


def test_atrous_smooth_and_reconstruct_match_jax():
    img = np.random.default_rng(9).normal(900, 200, (2, 40, 56)).astype(np.float32)
    for plane in (0, 2):
        # a batch is smoothed frame by frame, over the last two axes
        want = np.stack([np.asarray(jwav.atrous_smooth(
            jnp.asarray(fr), plane, jwav.TO_PAVE_LINEAR)) for fr in img])
        got = twav.atrous_smooth(torch.from_numpy(img), plane,
                                 twav.TO_PAVE_LINEAR)
        np.testing.assert_array_equal(got.numpy(), want)
    planes = twav.atrous_transform(torch.from_numpy(img[0]), 4)
    weights = np.array([2.0, 1.5, 1.0, 0.5], np.float32)
    want = np.asarray(jwav.atrous_reconstruct(jnp.asarray(planes.numpy()),
                                              jnp.asarray(weights)))
    got = twav.atrous_reconstruct(planes, torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    assert [twav.max_nplanes(*s) for s in ((64, 64), (640, 480), (3072, 2048))] \
        == [jwav.max_nplanes(*s) for s in ((64, 64), (640, 480), (3072, 2048))]


def test_wavelets_golden_vs_c():
    """c_wavelets.bin at the JAX test's tolerance (planes atol 0.5, rtol
    1e-5; words within 1 LSB on under 1% of the pixels)."""
    from siriltpu_torch.utils.rounding import np_round_to_word

    def c_reget(p):
        p = np.asarray(p, np.float64)
        mx = np.float32(p.astype(np.float32).max())
        ratio = 65535.0 / float(mx) if mx > 65535.0 else 1.0
        return np_round_to_word(p * ratio)

    r = Reader(os.path.join(GOLDEN_DIR, "c_wavelets.bin"))
    r.take("i"), r.take("i")
    ncases = 0
    while r.off < len(r.buf) - 63 * 4 - 63 * 2:
        nl, nc = r.take("H"), r.take("H")
        kind, nplanes = r.take("B"), r.take("B")
        img = r.take_u16s(nl * nc).reshape(nl, nc)
        want_planes = r.take_f32s(nplanes * nl * nc).reshape(nplanes, nl, nc)
        got = twav.atrous_transform(as_i32(img), nplanes, kind)
        np.testing.assert_allclose(got.numpy(), want_planes, atol=0.5,
                                   rtol=1e-5, err_msg=str((nl, nc, kind)))
        for plan in range(nplanes):
            want_w = r.take_u16s(nl * nc).reshape(nl, nc)
            word_close(c_reget(got[plan].numpy()), want_w, (nl, nc, kind, plan))
        coef = r.take_f32s(nplanes)
        want_w = r.take_u16s(nl * nc).reshape(nl, nc)
        rec = twav.atrous_reconstruct(got, torch.from_numpy(coef.copy()))
        word_close(c_reget(rec.numpy()), want_w, ("recon", nl, nc, kind))
        r.take_bytes(r.take("q"))       # the .wave file: ops/wave_io.py
        ncases += 1
    assert ncases == 6


# --------------------------------------------------------------------- PSF

def make_boxes(n: int = 24, side: int = 21, seed: int = 0):
    """(n, side, side) uint16 boxes of one elliptical Gaussian each on a
    sky of 1000 with noise, every second one rotated; box 3 has a hot
    pixel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[1:side + 1, 1:side + 1].astype(np.float64)
    boxes = []
    for i in range(n):
        x0, y0 = rng.uniform(8, 14, 2)
        sx, sy = rng.uniform(2, 12, 2)
        amp = rng.uniform(500, 40000)
        al = rng.uniform(-1, 1) if i % 2 else 0.0
        ca, sa = np.cos(al), np.sin(al)
        tx = ca * (xx - x0) - sa * (yy - y0)
        ty = sa * (xx - x0) + ca * (yy - y0)
        boxes.append(1000 + amp * np.exp(-(tx ** 2 / sx + ty ** 2 / sy))
                     + rng.normal(0, 15, (side, side)))
    boxes = np.clip(np.stack(boxes), 0, 65535).astype(np.uint16)
    boxes[3, 2, 2] = 60000
    return boxes, np.full(n, 1000, np.float32)


def test_psf_init_matches_jax():
    boxes, bgs = make_boxes()
    z = boxes.astype(np.float32)
    want = jax.vmap(jpsf._median3x3_neighbors)(jnp.asarray(z))
    got = tpsf._median3x3_neighbors(torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.stack([np.asarray(v) for v in jax.vmap(jpsf._init_params)(
        jnp.asarray(z), jnp.asarray(bgs))], axis=1)
    got = tpsf._init_params(torch.from_numpy(z), torch.from_numpy(bgs))
    np.testing.assert_array_equal(got.numpy(), want)


#: field -> (absolute, relative) tolerance of the LM fit against siriltpu
PSF_TOL = {"x0": (2e-3, 0), "y0": (2e-3, 0), "sx": (0, 2e-3), "sy": (0, 2e-3),
           "fwhmx": (0, 2e-3), "fwhmy": (0, 2e-3), "A": (0, 1e-3),
           "B": (1e-6, 1e-3), "rmse": (1e-7, 1e-3), "mag": (1e-3, 0),
           "angle": (0.1, 0)}


def assert_fits_close(got: dict, want: dict, rows=slice(None)):
    np.testing.assert_array_equal(got["ok"][rows], want["ok"][rows])
    for k, (atol, rtol) in PSF_TOL.items():
        np.testing.assert_allclose(got[k][rows], want[k][rows], rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("fit_angle", [False, True])
def test_fit_psf_batch_matches_jax(fit_angle):
    boxes, bgs = make_boxes()
    want = interop.psf_fit_to_numpy(jpsf.fit_psf_batch(
        jnp.asarray(boxes), jnp.asarray(bgs), fit_angle=fit_angle))
    fit = tpsf.fit_psf_batch(as_i32(boxes), torch.from_numpy(bgs),
                             fit_angle=fit_angle)
    got = interop.psf_fit_to_numpy(fit)
    assert set(got) == set(tpsf.PSFFit._fields) == set(want)
    assert all(v.shape == (len(boxes),) for v in got.values())
    assert got["ok"].all() and got["x0"].dtype == np.float32
    assert_fits_close(got, want)
    if fit_angle:
        assert (np.abs(got["angle"]) > 1).sum() >= 6, "the refit must take part"
        assert (got["sx"] >= got["sy"]).all()


def test_fit_psf_degenerate_boxes_do_not_raise():
    """A flat box makes the normal equations singular: like
    ``jnp.linalg.solve`` the port's solve gives no error and the step is
    rejected. Boxes of too few pixels are refused."""
    boxes, bgs = make_boxes(4)
    boxes[1] = 1000
    fit = tpsf.fit_psf_batch(as_i32(boxes), torch.from_numpy(bgs), fit_angle=True)
    want = interop.psf_fit_to_numpy(jpsf.fit_psf_batch(
        jnp.asarray(boxes), jnp.asarray(bgs), fit_angle=True))
    assert_fits_close(interop.psf_fit_to_numpy(fit), want, rows=[0, 2, 3])
    assert tpsf.fit_psf_single(np.ones((2, 3)), 0.0, device="cpu") is None
    small = tpsf.fit_psf_batch(torch.ones((1, 2, 3)), torch.zeros(1), fit_angle=False)
    assert not bool(small.ok[0])


def test_fit_psf_single_matches_jax():
    boxes, _ = make_boxes(6, seed=3)
    for i, fit_angle in ((1, True), (2, False)):
        want = jpsf.fit_psf_single(boxes[i], 1000.0, fit_angle=fit_angle)
        got = tpsf.fit_psf_single(boxes[i], 1000.0, device="cpu",
                                  fit_angle=fit_angle)
        assert set(got) == set(want)
        for k, (atol, rtol) in PSF_TOL.items():
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def test_psf_golden_vs_c():
    """c_psf.bin at the JAX test's own tolerance: the LM fit is
    tolerance-held even in the reference."""
    r = Reader(os.path.join(GOLDEN_DIR, "c_psf.bin"))
    fields = ("B", "A", "x0", "y0", "sx", "sy", "fwhmx", "fwhmy", "angle",
              "mag", "rmse")
    ncases = 0
    while not r.eof():
        bs = r.take("H")
        fit_angle = bool(r.take("B"))
        img = r.take_u16s(bs * bs).reshape(bs, bs)
        bg = r.take("d")
        want = dict(zip(fields, (r.take("d") for _ in fields)))
        got = tpsf.fit_psf_single(img, bg, device="cpu", fit_angle=fit_angle)
        assert got is not None, ncases
        for k in ("x0", "y0"):
            assert abs(got[k] - want[k]) < 0.02, (ncases, k, got[k], want[k])
        for k in ("B", "A", "sx", "sy", "fwhmx", "fwhmy"):
            assert abs(got[k] - want[k]) < 0.015 * max(abs(want[k]), 1e-6), (
                ncases, k, got[k], want[k])
        assert abs(got["mag"] - want["mag"]) < 0.02, (ncases, got, want)
        if fit_angle and abs(want["angle"]) > 1e-6:
            assert abs(got["angle"] - want["angle"]) < 1.5, (ncases, got, want)
        ncases += 1
    assert ncases == 5


# -------------------------------------------------------------- photometry

def test_photometry_matches_jax_and_golden():
    r = Reader(os.path.join(GOLDEN_DIR, "c_photometry.bin"))
    for _ in range(36):
        n = r.take("i")
        r.take("B")
        xs = np.asarray(r.take("d" * n)) if n > 1 else np.asarray([r.take("d")])
        ret, mean, stdev = r.take("i"), r.take("d"), r.take("d")
        got = tphot.robustmean(xs)
        assert got == jphot.robustmean(xs)
        assert got[2] == ret
        np.testing.assert_allclose(got[0], mean, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got[1], stdev, rtol=1e-8, atol=1e-10)
    nb = 0
    while not r.eof():
        w, h = r.take("i"), r.take("i")
        x0, y0, sx = r.take("ddd")
        z = np.asarray(r.take("d" * (w * h))).reshape(h, w)
        ok = r.take("B")
        nb += 1
        got = tphot.get_photometry(z, x0, y0, sx, tphot.PhotConfig())
        want = jphot.get_photometry(z, x0, y0, sx, jphot.PhotConfig())
        if not ok:
            assert got is None and want is None
            continue
        mag, s_mag = r.take("dd")
        assert (got.mag, got.s_mag) == (want.mag, want.s_mag)
        np.testing.assert_allclose(got.mag, mag, rtol=1e-11)
        np.testing.assert_allclose(got.s_mag, s_mag, rtol=1e-9)
    assert nb == 6
    assert tphot.get_photometry(np.full((50, 50), 100.0), 25.0, 25.0, 500.0) is None
    assert tphot.get_mag_err(100.0, 30.0, 50, 2.0, 2.3) \
        == jphot.get_mag_err(100.0, 30.0, 50, 2.0, 2.3)


# --------------------------------------------------------------- star finder

def star_layers(n: int = 3) -> np.ndarray:
    return np.stack([starfield(FH, FW, 14, seed=100 + i, background=800,
                               noise_sigma=5.0)[0][0] for i in range(n)])


def jax_candidates(score: np.ndarray, krow: int, kmax: int):
    """The JAX package's two-stage ``top_k`` chain
    (siriltpu/ops/starfind.py:186-204)."""
    h, w = score.shape
    rv, ri = jax.lax.top_k(jnp.asarray(score), min(krow, w))
    flat_idx = jnp.arange(h, dtype=jnp.int32)[:, None] * w + ri.astype(jnp.int32)
    vals, sel = jax.lax.top_k(rv.reshape(-1), min(kmax, rv.size))
    idx = np.asarray(flat_idx.reshape(-1)[sel])[np.asarray(vals) >= 0]
    return idx // w, idx % w


def test_detect_peaks_matches_jax():
    """The peak mask at tolerance 0, on an image with plateaus (equal
    neighbours), values at the threshold and at the norm, and a window."""
    rng = np.random.default_rng(5)
    wave = rng.integers(0, 40, (FH, FW)).astype(np.int32) * 50
    wave[40:43, 50:53] = 1900           # a plateau: only its first pixel
    wave[80, 90] = 65535                # at the norm: not a peak
    for radius, bounds in ((10, (0, 0, FW, FH)), (3, (20, 30, 150, 120))):
        want = jsf._detect_peaks(jnp.asarray(wave), jnp.int32(1000),
                                 jnp.int32(65535), radius,
                                 jnp.asarray(bounds, jnp.int32))
        got = tsf._detect_peaks(torch.from_numpy(wave), 1000, 65535, radius, bounds)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not bool(got[80, 90])
    assert bool(got[40, 50]) and int(got[40:43, 50:53].sum()) == 1


@pytest.mark.parametrize("cap", [8192, 100])
def test_candidate_selection_matches_jax_top_k(cap):
    """The kept candidates and their order equal the JAX package's
    ``top_k`` chain: score descending, scan order among equal scores, at
    most ROW_CANDIDATES of a row (the row cap is shrunk to 4 here so that
    a small image reaches it) and ``cap`` of a frame."""
    rng = np.random.default_rng(6)
    wave = rng.integers(1, 30, (40, 64)).astype(np.int32)    # many ties
    mask = rng.random((40, 64)) < 0.3
    mask[7] = True                                          # a full row
    score = np.where(mask, wave, -1).astype(np.int32)
    old = tsf.ROW_CANDIDATES
    tsf.ROW_CANDIDATES = 4
    try:
        ys, xs = tsf._select_candidates(torch.from_numpy(wave),
                                        torch.from_numpy(mask), cap)
    finally:
        tsf.ROW_CANDIDATES = old
    wy, wx = jax_candidates(score, 4, cap)
    assert len(wy) == min(cap, 160) or len(wy) < 160
    np.testing.assert_array_equal(ys.numpy(), wy)
    np.testing.assert_array_equal(xs.numpy(), wx)


def assert_same_stars(got, want):
    g, w = interop.stars_to_fields(got), interop.stars_to_fields(want)
    assert len(got) == len(want)
    for k in ("xpos", "ypos"):
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=2e-3, err_msg=k)
    np.testing.assert_allclose(g["mag"], w["mag"], rtol=0, atol=1e-3)
    for k in ("fwhmx", "fwhmy", "sx", "sy", "A"):
        np.testing.assert_allclose(g[k], w[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(g["B"], w["B"], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(g["layer"], w["layer"])


def test_peaker_matches_jax():
    layer = star_layers(1)[0]
    want = jsf.peaker(layer, layer_index=1)
    got, dev = tsf.peaker(layer, device="cpu", layer_index=1,
                          return_device=True)
    assert len(got) >= 10 and dev.dtype == torch.uint16
    assert [s.mag for s in got] == sorted(s.mag for s in got)
    assert_same_stars(got, want)
    # the carriers: a star list crosses as plain columns and comes back
    assert interop.stars_from_fields(interop.stars_to_fields(got)) == got
    # the layer already on the device, and a detection window
    sf = tsf.StarFinderParams(radius=8, sigma=1.5, roundness=0.6)
    area = (30, 20, 120, 110)
    want = jsf.peaker(layer, params=jsf.StarFinderParams(8, 1.5, 0.6),
                      area=jframe.Rect(*area))
    got = tsf.peaker(layer, device="cpu", params=sf, area=tframe.Rect(*area),
                     layer_dev=dev)
    assert 0 < len(got) < 10
    assert_same_stars(got, want)


def test_peaker_empty_and_null_layers():
    rng = np.random.default_rng(1)
    noisy = np.clip(100 + rng.normal(0, 2, (FH, FW)), 0, 65535).astype(np.uint16)
    assert tsf.peaker(noisy, device="cpu") == jsf.peaker(noisy) == []
    null = np.zeros((FH, FW), np.uint16)
    assert tsf.peaker(null, device="cpu", return_device=True) == ([], None)
    assert tsf.peaker_batch(np.stack([null, noisy]), device="cpu") == [[], []]


def test_peaker_batch_matches_peaker_and_jax():
    layers = star_layers(3)
    got, dev = tsf.peaker_batch(layers, device="cpu", nmax=256,
                                return_device=True)
    assert dev.shape == layers.shape
    want = jsf.peaker_batch(layers, nmax=256)
    for i in range(3):
        # the same device code, frame by frame: equal, not only close
        assert got[i] == tsf.peaker(layers[i], device="cpu")
        assert_same_stars(got[i], want[i])
    # nmax caps the candidates at the brightest peaks
    few = tsf.peaker_batch(layers[:1], device="cpu", nmax=4)[0]
    assert_same_stars(few, jsf.peaker_batch(layers[:1], nmax=4)[0])
    assert 0 < len(few) <= 4
    # over a frames mesh (parallel/mesh.py): the same lists, no device copy
    from siriltpu_torch.parallel.mesh import make_mesh
    assert tsf.peaker_batch(layers, device="cpu", nmax=256, return_device=True,
                            mesh=make_mesh(devices=["cpu"] * 2)) == (got, None)
    with pytest.raises(TypeError):
        tsf.peaker(layers[0])  # no device


def test_starfind_golden_vs_c():
    """c_starfind.bin as the JAX test holds it: the star sets matched by
    position, with the allowance for the reference's transposed fit box
    (tests/test_c_goldens.py:803)."""
    r = Reader(os.path.join(GOLDEN_DIR, "c_starfind.bin"))
    w, h, radius = r.take("H"), r.take("H"), r.take("H")
    sigma, roundness = r.take("d"), r.take("d")
    img = r.take_u16s(w * h).reshape(h, w)
    n = r.take("i")
    cstars = []
    for _ in range(n):
        xpos, ypos = r.take("d"), r.take("d")
        cstars.append((xpos, ypos, [r.take("d") for _ in range(11)]))
    assert r.eof() and n >= 15
    got = tsf.peaker(img, device="cpu", params=tsf.StarFinderParams(
        radius=radius, sigma=sigma, roundness=roundness))
    matched = 0
    for cx, cy, cv in cstars:
        d, k = min((((s.xpos - cx) ** 2 + (s.ypos - cy) ** 2) ** 0.5, k)
                   for k, s in enumerate(got))
        if d < 1.6:
            matched += 1
            s = got[k]
            assert abs((s.xpos + s.ypos) - (cx + cy)) < 0.06, (cx, cy, s)
            assert abs(s.mag - cv[9]) < 0.05, (cx, cy, s.mag, cv[9])
            assert abs(s.B - cv[0]) < 0.01, (cx, cy)
            assert abs(s.A - cv[1]) < 0.03 * max(cv[1], 1e-6), (cx, cy)
            assert abs(max(s.sx, s.sy) - max(cv[4], cv[5])) < 0.05 * max(
                cv[4], 1.0), (cx, cy, s)
            assert abs(min(s.sx, s.sy) - min(cv[4], cv[5])) < 0.05 * max(
                cv[5], 1.0), (cx, cy, s)
    assert matched >= n - 2, (matched, n, len(got))
    assert abs(len(got) - n) <= 3, (len(got), n)
    assert_same_stars(got, jsf.peaker(img, params=jsf.StarFinderParams(
        radius=radius, sigma=sigma, roundness=roundness)))


# ----------------------------------------------------------------- one star

def one_star_sequences(positions, noise=5.0, h=128, w=128):
    """Frames of one Gaussian star at the given bottom-up (x, y), as an
    internal sequence of each package."""
    frames = []
    for i, (x, y) in enumerate(positions):
        img = 800.0 + gaussian_star(h, w, x, y, 20000.0, 7.0, 7.0)
        img += np.random.default_rng(i).normal(0, noise, img.shape)
        frames.append(np.clip(np.rint(img), 0, 65535).astype(np.uint16)[None])
    return (jsequence.internal_sequence([jframe.Frame(f) for f in frames]),
            tsequence.internal_sequence([tframe.Frame(f) for f in frames]))


def assert_same_psf_results(got, want):
    assert [r.ok for r in got] == [r.ok for r in want]
    assert [r.image_index for r in got] == [r.image_index for r in want]
    for g, w in zip(got, want):
        for k, tol in (("xpos", 2e-3), ("ypos", 2e-3), ("mag", 1e-3)):
            assert abs(getattr(g, k) - getattr(w, k)) <= tol, (k, g, w)
        for k in ("fwhmx", "fwhmy", "rmse"):
            assert abs(getattr(g, k) - getattr(w, k)) <= 2e-3 * abs(getattr(w, k)), (k, g, w)
        assert g.exposure == w.exposure
        assert (g.photometry is None) == (w.photometry is None)
        if g.photometry is not None:
            assert abs(g.photometry.mag - w.photometry.mag) < 1e-3
            assert abs(g.photometry.s_mag - w.photometry.s_mag) < 1e-4


@pytest.mark.parametrize("follow_star", [False, True])
def test_register_onestar_matches_jax(follow_star):
    drifts = [(0, 0), (3, -2), (-4, 5), (2, 2), (6, 6)]
    jseq, tseq = one_star_sequences([(60.0 + dx, 70.0 + dy) for dx, dy in drifts])
    for seq in (jseq, tseq):
        seq.set_included(3, False)
    sel = (60 - 20, (127 - 70) - 20, 40, 40)        # top-down
    want = jone.register_onestar(jseq, 0, jframe.Rect(*sel),
                                 follow_star=follow_star)
    got = tone.register_onestar(tseq, 0, tframe.Rect(*sel), device="cpu",
                                follow_star=follow_star)
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 2e-3 * want[1]
    assert_same_psf_results(got[2], want[2])
    np.testing.assert_array_equal(tseq.reg_shifts(0), jseq.reg_shifts(0))
    for i, (dx, dy) in enumerate(drifts):
        if i != 3:
            assert tuple(tseq.reg_shifts(0)[i]) == (-dx, -dy)
    a = interop.sequence_to_fields(tseq)["reg"][0]
    b = interop.sequence_to_fields(jseq)["reg"][0]
    np.testing.assert_allclose(a, b, rtol=2e-3)      # the fwhm column
    assert tseq.needs_saving and not got[2][3].ok


def test_seqpsf_follow_star_and_photometry_match_jax():
    """FOLLOW_STAR tracks a star that leaves the first box; in light-curve
    mode every frame carries its aperture photometry."""
    positions = [(40.0, 60.0), (48.0, 64.0), (56.0, 68.0), (64.0, 72.0)]
    jseq, tseq = one_star_sequences(positions, noise=0.0)
    sel = (40 - 15, (127 - 60) - 15, 30, 30)
    for follow_star in (True, False):
        want = jone.seqpsf(jseq, 0, jframe.Rect(*sel), follow_star=follow_star,
                           for_registration=False,
                           phot_config=jphot.PhotConfig(inner=9, outer=14))
        got = tone.seqpsf(tseq, 0, tframe.Rect(*sel), device="cpu",
                          follow_star=follow_star, for_registration=False,
                          phot_config=tphot.PhotConfig(inner=9, outer=14))
        assert_same_psf_results(got, want)
        assert got[0].photometry is not None
    follow = tone.seqpsf(tseq, 0, tframe.Rect(*sel), device="cpu",
                         follow_star=True)
    for r, (x, y) in zip(follow, positions):
        assert r.ok and abs(r.xpos - (x + 1)) < 0.5 and abs(127 - r.ypos - y) < 0.5
    with pytest.raises(ValueError, match="reference frame"):
        tone.register_onestar(tseq, 0, tframe.Rect(90, 5, 2, 3), device="cpu")


# ------------------------------------------------------------------- memory

@pytest.mark.parametrize("h,w,n_devices", [(2048, 3072, 1), (480, 640, 1),
                                           (4096, 4096, 4), (20000, 20000, 8)])
def test_starfind_chunk_frames_matches_jax(monkeypatch, h, w, n_devices):
    """With the same memory budget (the JAX package's CPU figure) the
    chunk is the same; on a card the port asks the device."""
    monkeypatch.setattr(tmemory, "get_device_memory_bytes",
                        lambda device: jmemory.get_device_memory_bytes())
    assert tmemory.starfind_chunk_frames(h, w, device="cpu", n_devices=n_devices) \
        == jmemory.starfind_chunk_frames(h, w, n_devices)
    assert tmemory.starfind_chunk_frames(h, w, device="cpu", nmax=512, box=41) \
        == jmemory.starfind_chunk_frames(h, w, nmax=512, box=41)
