"""Calibration of siriltpu_torch against siriltpu and the compiled
reference: ``ops/imops.py``, ``ops/cosmetic.py``,
``pipelines/preprocess.py``.

Both packages get the same seeded NumPy frames (at most 120 x 160, 4
frames). Tolerances:

- every function that is host NumPy in the JAX package is the same code
  here: tolerance 0 (the image arithmetic with its MUL overflow quirk and
  fdiv's zeroed divisor, crops and flips, entropy, the LUTs, fill, shift,
  the median filter, banding reduction, cosmetic detection and fixes,
  ``preprocess_single``, ``dark_optimization``'s k and image, and the
  ``pp_`` FITS and SER files of ``seq_preprocess``, compared byte for
  byte);
- ``ddp`` and ``unsharp`` blur with the port's ``sep_filter``, in the JAX
  package's order of float32 operations: tolerance 0;
- ``resize`` multiplies two float32 matrices as the JAX package does
  (full float32, no TF32), but torch's and XLA's matmuls sum in other
  orders: words within 1 LSB on at most 0.5% of the pixels;
- ``rotate`` is the port's gather warp, where the JAX package takes its
  tiled sampler at small angles: as ``ops/warp.py``'s tests hold them,
  within 1 LSB on at most 0.1% of the words (nearest: words differ on at
  most 1e-3 of the pixels, a .5 boundary taking the neighbour);
- ``background_noise``: the B-spline wavelet plane differs from the JAX
  package's by one unit in the last place (XLA contracts its taps into
  fused multiply-adds), which can move a rounded word: sigma within
  1e-6 relative;
- ``c_imops.bin`` and ``c_cosmetic.bin`` at the JAX tests' tolerances.
"""

import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.io import ser as tser  # noqa: E402
from siriltpu_torch.ops import cosmetic as tcos  # noqa: E402
from siriltpu_torch.ops import imops as ti  # noqa: E402
from siriltpu_torch.pipelines import preprocess as tpp  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
H, W = 72, 96


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.core import frame
    from siriltpu.io import fits, sequence, ser
    from siriltpu.ops import cosmetic, imops
    from siriltpu.pipelines import preprocess
    return SimpleNamespace(frame=frame, fits=fits, sequence=sequence, ser=ser,
                           cosmetic=cosmetic, imops=imops, preprocess=preprocess)


def make_img(c: int, seed: int, h: int = H, w: int = W, hi: int = 65535):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi + 1, (c, h, w)).astype(np.uint16)


def make_sky(c: int, seed: int, h: int = H, w: int = W):
    """Sky near 1000 with stars, hot and cold pixels."""
    rng = np.random.default_rng(seed)
    img = 1000 + rng.normal(0, 20, (c, h, w))
    img[:, rng.integers(0, h, 15), rng.integers(0, w, 15)] += 20000
    img[:, rng.integers(0, h, 5), rng.integers(0, w, 5)] = 0
    return np.clip(img, 0, 65535).astype(np.uint16)


# ------------------------------------------------------------------ imops

@pytest.mark.parametrize("oper", ("add", "sub", "mul", "div"))
def test_arithmetic_matches_jax(jx, oper):
    a, b = make_img(3, 1), make_img(3, 2)
    b[0, :3] = 0        # fdiv's and imoper's zero divisors
    a[1, :2] = 65535    # products past INT_MAX (the MUL quirk)
    b[1, :2] = 65535
    for scalar in (0.7, 3.0, 1234.5):
        np.testing.assert_array_equal(ti.soper(a, scalar, oper),
                                      jx.imops.soper(a, scalar, oper))
    np.testing.assert_array_equal(ti.imoper(a, b, oper), jx.imops.imoper(a, b, oper))
    got, want = ti.fdiv(a, b, 1.3), jx.imops.fdiv(a, b, 1.3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(ti.ndiv(a, b), jx.imops.ndiv(a, b))
    with pytest.raises(ValueError):
        ti.imoper(a, b[:1], oper)


def test_host_transforms_match_jax(jx):
    img = make_sky(3, 3)
    rect = tframe.Rect(5, 7, 40, 21)
    jrect = jx.frame.Rect(5, 7, 40, 21)
    for name in ("mirrorx", "mirrory", "rotate_pi"):
        np.testing.assert_array_equal(getattr(ti, name)(img), getattr(jx.imops, name)(img))
    np.testing.assert_array_equal(ti.crop(img, 5, 7, 40, 21), jx.imops.crop(img, 5, 7, 40, 21))
    np.testing.assert_array_equal(ti.addmax(img, img[::-1]), jx.imops.addmax(img, img[::-1]))
    for level in (900, 1100):
        for name in ("threshlo", "threshhi", "nozero"):
            np.testing.assert_array_equal(getattr(ti, name)(img, level),
                                          getattr(jx.imops, name)(img, level))
        np.testing.assert_array_equal(ti.fill(img, level, rect), jx.imops.fill(img, level, jrect))
        np.testing.assert_array_equal(ti.off(img, -level), jx.imops.off(img, -level))
    np.testing.assert_array_equal(ti.fill(img, 7), jx.imops.fill(img, 7))
    for inv in (False, True):
        np.testing.assert_array_equal(ti.loglut(img, inv), jx.imops.loglut(img, inv))
    for sx, sy in ((3, -2), (-5, 4), (0, 0)):
        np.testing.assert_array_equal(ti.shift_image(img, sx, sy),
                                      jx.imops.shift_image(img, sx, sy))
    assert ti.entropy(img[0]) == jx.imops.entropy(img[0])
    assert ti.entropy(img[0], rect=rect) == jx.imops.entropy(img[0], rect=jrect)
    assert ti.contrast(img[1], 1000.5) == jx.imops.contrast(img[1], 1000.5)
    np.testing.assert_array_equal(ti.median_filter(img, 3, 0.6, 2),
                                  jx.imops.median_filter(img, 3, 0.6, 2))
    for protect, rot in ((True, False), (False, True)):
        np.testing.assert_array_equal(
            ti.banding_reduction(img, 1.5, 0.8, protect, rot),
            jx.imops.banding_reduction(img, 1.5, 0.8, protect, rot))
    np.testing.assert_array_equal(ti.sub_background_layer(img[0], img[1]),
                                  jx.imops.sub_background_layer(img[0], img[1]))


def test_blurs_match_jax(jx):
    img = make_sky(3, 4)
    for sigma, amount in ((1.0, 0.0), (2.5, 1.5)):
        np.testing.assert_array_equal(ti.unsharp(img, sigma, amount, device="cpu"),
                                      jx.imops.unsharp(img, sigma, amount))
    for sigma in (0.0, 1.7):
        np.testing.assert_array_equal(ti.ddp(img, 900.0, 30000.0, sigma, device="cpu"),
                                      jx.imops.ddp(img, 900.0, 30000.0, sigma))


@pytest.mark.parametrize("interp", (0, 1, 2, 3, 4))
def test_resize_matches_jax(jx, interp):
    img = make_sky(3, 5)
    for nw, nh in ((131, 57), (48, 36)):
        got = ti.resize(img, nw, nh, interp, device="cpu")
        want = jx.imops.resize(img, nw, nh, interp)
        d = np.abs(got.astype(np.int64) - want)
        assert d.max() <= 1 and (d != 0).mean() <= 5e-3, (nw, nh, d.max(), (d != 0).mean())


@pytest.mark.parametrize("interp", (0, 1, 2, 4))
def test_rotate_matches_jax(jx, interp):
    img = make_sky(1, 6)
    for angle, crop in ((7.0, True), (33.0, False)):
        got = ti.rotate(img, angle, crop_to_fit=crop, interpolation=interp, device="cpu")
        want = jx.imops.rotate(img, angle, crop_to_fit=crop, interpolation=interp)
        assert got.shape == want.shape
        d = np.abs(got.astype(np.int64) - want)
        if interp == 0:
            assert (d != 0).mean() <= 1e-3, (angle, (d != 0).sum())
        else:
            assert d.max() <= 1 and (d != 0).mean() <= 1e-3, (angle, d.max(), (d != 0).sum())


def test_background_noise_matches_jax(jx):
    img = make_sky(3, 8, 80, 96)
    np.testing.assert_allclose(ti.background_noise(img, device="cpu"),
                               jx.imops.background_noise(img), rtol=1e-6)


def test_lrgb_names_the_module_it_waits_for():
    img = make_sky(1, 9)[0]
    with pytest.raises(NotImplementedError, match="pipelines/compositing.py"):
        ti.lrgb(img, img, img, img)


class _Reader:
    def __init__(self, name):
        with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
            self.buf = f.read()
        self.off = 0

    def eof(self):
        return self.off >= len(self.buf)

    def take(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.buf, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def u16s(self, n, shape):
        a = np.frombuffer(self.buf, "<u2", n, self.off).reshape(shape).copy()
        self.off += 2 * n
        return a

    def f32(self):
        v = np.frombuffer(self.buf, "<f4", 1, self.off)[0]
        self.off += 4
        return v


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_imops.bin")),
                    reason="c_imops.bin not generated")
def test_imops_vs_c_golden():
    """The port's imops against the compiled core/siril.c blocks, as
    tests/test_c_goldens.py:test_imops_vs_c holds the JAX package."""
    from siriltpu_torch.ops.stats import STATS_BASIC, statistics

    r = _Reader("c_imops.bin")
    nx, ny = 31, 17
    for _rep in range(2):
        for li in range(2):
            nl = 3 if li else 1
            n = nx * ny * nl
            assert r.take("B") == nl
            scalar = r.take("d")
            coef = r.f32()
            a, b = r.u16s(n, (nl, ny, nx)), r.u16s(n, (nl, ny, nx))
            for op in ("add", "sub", "mul", "div"):
                np.testing.assert_array_equal(ti.soper(a, scalar, op), r.u16s(n, a.shape))
                np.testing.assert_array_equal(ti.imoper(a, b, op), r.u16s(n, a.shape))
            want_ret = r.take("B")
            got, ret = ti.fdiv(a, b, float(coef))
            assert ret == want_ret
            np.testing.assert_array_equal(got, r.u16s(n, a.shape))
            np.testing.assert_array_equal(ti.addmax(a, b), r.u16s(n, a.shape))
    one = (ny, nx)
    img = r.u16s(nx * ny, one)
    np.testing.assert_allclose(ti.entropy(img), r.take("d"), rtol=1e-12)
    np.testing.assert_allclose(ti.entropy(img, rect=tframe.Rect(5, 3, 20, 11)),
                               r.take("d"), rtol=1e-12)
    st = SimpleNamespace(median=r.take("d"), sigma=r.take("d"))
    np.testing.assert_allclose(ti.entropy(img, stats=st), r.take("d"), rtol=1e-12)
    img = r.u16s(nx * ny, one)
    logw = r.u16s(nx * ny, one)
    np.testing.assert_array_equal(ti.loglut(img), logw)
    np.testing.assert_array_equal(ti.loglut(logw, inverted=True), r.u16s(nx * ny, one))
    img = r.u16s(nx * ny, one)
    stf = statistics(img, option=STATS_BASIC, nullcheck=True)
    np.testing.assert_allclose(ti.contrast(img, stf.mean), r.take("d"), rtol=1e-12)
    sts = statistics(img, selection=tframe.Rect(4, 2, 12, 9), option=STATS_BASIC,
                     nullcheck=True)
    np.testing.assert_allclose(ti.contrast(img, sts.mean), r.take("d"), rtol=1e-12)
    layer = (1, ny, nx)
    img = r.u16s(nx * ny, layer)
    np.testing.assert_array_equal(ti.fill(img, 4242, tframe.Rect(7, 2, 13, 8)),
                                  r.u16s(nx * ny, layer))
    np.testing.assert_array_equal(ti.off(img, 20000), r.u16s(nx * ny, layer))
    np.testing.assert_array_equal(ti.off(img, -20000), r.u16s(nx * ny, layer))
    bx, by = 64, 48
    for _ in range(4):
        img = r.u16s(bx * by, (1, by, bx))
        sigma, amount = r.take("d"), r.take("d")
        protect = bool(r.take("B"))
        np.testing.assert_array_equal(
            ti.banding_reduction(img, sigma, amount, protect_highlights=protect),
            r.u16s(bx * by, (1, by, bx)))
    img = r.u16s(nx * ny, layer)
    np.testing.assert_array_equal(ti.threshlo(img, 12000), r.u16s(nx * ny, layer))
    np.testing.assert_array_equal(ti.threshhi(img, 50000), r.u16s(nx * ny, layer))
    np.testing.assert_array_equal(ti.nozero(img, 777), r.u16s(nx * ny, layer))
    img = r.u16s(nx * ny, layer)
    for _ in range(4):
        sx = r.take("H")
        sy = r.take("H")
        sx, sy = (v - 65536 if v >= 32768 else v for v in (sx, sy))
        np.testing.assert_array_equal(ti.shift_image(img, int(sx), int(sy)),
                                      r.u16s(nx * ny, layer))
    bx, by = 96, 80
    img = r.u16s(bx * by, (1, by, bx))
    np.testing.assert_allclose(ti.background_noise(img, device="cpu")[0], r.take("d"),
                               rtol=1e-9)
    assert r.eof()


# --------------------------------------------------------------- cosmetic

@pytest.mark.parametrize("cfa", (False, True))
def test_cosmetic_matches_jax(jx, cfa):
    dark = make_sky(1, 10)[0]
    light = make_sky(1, 11)[0]
    for sig in ((3.0, 3.0), (-1.0, 2.0), (2.0, -1.0)):
        got, gc, gh = tcos.find_deviant_pixels(dark, sig)
        want, wc, wh = jx.cosmetic.find_deviant_pixels(dark, sig)
        assert (gc, gh) == (wc, wh)
        fields = interop.deviants_to_fields(got)
        for col, vals in interop.deviants_to_fields(want).items():
            np.testing.assert_array_equal(fields[col], vals)
        back = interop.deviants_from_fields(interop.deviants_to_fields(want))
        np.testing.assert_array_equal(tcos.cosmetic_correction(light, back, cfa),
                                      jx.cosmetic.cosmetic_correction(light, want, cfa))
    for row in (0, 17, H - 1):
        np.testing.assert_array_equal(tcos.fix_line(light, row, cfa),
                                      jx.cosmetic.fix_line(light, row, cfa))
    got = tcos.auto_detect_and_fix(light, (3.0, 3.0), cfa)
    want = jx.cosmetic.auto_detect_and_fix(light, (3.0, 3.0), cfa)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_cosmetic.bin")),
                    reason="c_cosmetic.bin not generated")
def test_cosmetic_vs_c_golden():
    r = _Reader("c_cosmetic.bin")
    ncases = 0
    while not r.eof():
        nx, ny = r.take("H"), r.take("H")
        sig0, sig1 = r.take("dd")
        img = r.u16s(nx * ny, (ny, nx))
        icold, ihot = r.take("q"), r.take("q")
        cdevs = []
        for _ in range(r.take("i")):
            x, y = r.take("dd")
            cdevs.append((int(x), int(y), tcos.HOT_PIXEL if r.take("B") == 1
                          else tcos.COLD_PIXEL))
        ncases += 1
        devs, gicold, gihot = tcos.find_deviant_pixels(img, (sig0, sig1))
        assert (gicold, gihot) == (icold, ihot)
        assert [(d.x, d.y, d.type) for d in devs] == cdevs
        for cfa in (False, True):
            np.testing.assert_array_equal(tcos.cosmetic_correction(img, devs, is_cfa=cfa),
                                          r.u16s(nx * ny, (ny, nx)))
    assert ncases == 8


# ------------------------------------------------------------- preprocess

def _masters(c: int = 1):
    rng = np.random.default_rng(12)
    offset = np.clip(rng.normal(200, 3, (c, H, W)), 0, 65535).astype(np.uint16)
    dark = np.clip(offset + rng.normal(300, 15, (c, H, W)), 0, 65535).astype(np.uint16)
    dark[:, 5, 7] = 60000    # a hot pixel
    dark[:, 30, 40] = 0      # a cold one
    yy, xx = np.mgrid[0:H, 0:W]
    flat = np.clip(30000 - 40 * np.hypot(yy - H / 2, xx - W / 2) + rng.normal(0, 50, (c, H, W)),
                   0, 65535).astype(np.uint16)
    flat[:, 0, :4] = 0       # fdiv's zeroed divisor
    return offset, dark, flat


def _lights(n: int, c: int = 1):
    offset, dark, flat = _masters(c)
    out = []
    for i in range(n):
        sky = make_sky(c, 20 + i).astype(np.float64)
        out.append(np.clip(sky * flat / 30000 + 1.1 * (dark.astype(np.float64) - offset)
                           + offset, 0, 65535).astype(np.uint16))
    return out


CONFIGS = {
    "offset_dark_flat": dict(use_offset=True, use_dark=True, use_flat=True),
    "dark_optim": dict(use_offset=True, use_dark=True, use_dark_optim=True),
    "flat_fixed_level": dict(use_flat=True, autolevel=False, normalisation=25000.0),
    "dark_cosmetic": dict(use_dark=True, use_cosmetic=True, sigma=(3.0, 3.0)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_preprocess_single_matches_jax(jx, name):
    offset, dark, flat = _masters(3)
    brut = _lights(1, 3)[0]
    cfg = jx.preprocess.PreproConfig(**CONFIGS[name])
    tcfg = interop.prepro_config_from_fields(interop.config_to_fields(cfg))
    got = tpp.preprocess_single(brut, offset=offset, dark=dark, flat=flat, config=tcfg)
    want = jx.preprocess.preprocess_single(brut, offset=offset, dark=dark, flat=flat,
                                           config=cfg)
    np.testing.assert_array_equal(got, want)


def test_dark_optimization_matches_jax(jx):
    offset, dark, _ = _masters(1)
    brut = _lights(1, 1)[0]
    for use_offset in (False, True):
        got, gk = tpp.dark_optimization(brut, dark, offset, use_offset)
        want, wk = jx.preprocess.dark_optimization(brut, dark, offset, use_offset)
        assert gk == wk
        np.testing.assert_array_equal(got, want)
    assert (tpp.golden_section_search(brut, dark, 0.5, 1.5, 1e-2)
            == jx.preprocess.golden_section_search(brut, dark, 0.5, 1.5, 1e-2))
    assert (tpp.evaluate_noise_of_calibrated(brut, dark, 0.8)
            == jx.preprocess.evaluate_noise_of_calibrated(brut, dark, 0.8))


@pytest.mark.parametrize("kind", ("fits", "ser"))
def test_seq_preprocess_writes_pp_files_equal_to_jax(jx, tmp_path, kind):
    """seq_preprocess over a FITS and a SER sequence: the calibrated
    frames and the pp_ files, byte for byte, equal the JAX package's."""
    offset, dark, flat = _masters(1)
    lights = _lights(4, 1)
    files = {}
    for pkg, io_fits, io_seq, io_ser, frame, pp, mk in (
            ("jax", jx.fits, jx.sequence, jx.ser, jx.frame, jx.preprocess, None),
            ("port", tfits, tsequence, tser, tframe, tpp, interop.prepro_config_from_fields)):
        d = tmp_path / pkg
        d.mkdir()
        if kind == "fits":
            for i, fr in enumerate(lights):
                io_fits.write_fits(str(d / f"light_{i + 1:03d}.fit"), frame.Frame(fr))
            seq = io_seq.check_seq(str(d))[0]
        else:
            s = io_ser.SerFile.create(str(d / "light.ser"), W, H)
            for fr in lights:
                s.write_frame(frame.Frame(fr))
            s.write_and_close()
            seq = io_seq.ser_sequence(str(d / "light.ser"))
        cfg = jx.preprocess.PreproConfig(use_offset=True, use_dark=True, use_flat=True,
                                         use_cosmetic=True)
        if mk is not None:
            cfg = mk(interop.config_to_fields(cfg))
        out = pp.seq_preprocess(seq, offset=frame.Frame(offset), dark=frame.Frame(dark),
                                flat=frame.Frame(flat), config=cfg)
        assert len(out) == 4
        files[pkg] = ({p.name: p.read_bytes() for p in d.iterdir()
                       if p.name.startswith("pp_")}, [f.data for f in out])
    assert sorted(files["port"][0]) == sorted(files["jax"][0])
    assert len(files["port"][0]) == (4 if kind == "fits" else 1)
    for name, data in files["jax"][0].items():
        assert files["port"][0][name] == data, name
    for got, want in zip(files["port"][1], files["jax"][1]):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: resize and rotate run there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("interp", (0, 1, 2, 3, 4))
def test_cuda_resize_and_rotate_match_cpu(cuda_device, interp):
    """resize's float32 matmuls on the card in full float32 (not TF32):
    cuBLAS sums in another order than the CPU, so words within 1 LSB on at
    most 0.5%; rotate's gather warp equal to the CPU's (lanczos4 within 1
    LSB: ``sin`` differs in the last unit)."""
    img = make_sky(3, 13)
    got = ti.resize(img, 131, 57, interp, device=cuda_device)
    want = ti.resize(img, 131, 57, interp, device="cpu")
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1 and (d != 0).mean() <= 5e-3, (d.max(), (d != 0).mean())
    got = ti.rotate(img, 7.0, interpolation=interp, device=cuda_device)
    want = ti.rotate(img, 7.0, interpolation=interp, device="cpu")
    assert np.abs(got.astype(np.int64) - want).max() <= (1 if interp == 4 else 0)
