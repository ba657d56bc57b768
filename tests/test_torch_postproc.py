"""Post-processing of siriltpu_torch against siriltpu and the compiled
reference: ``ops/colors.py``, ``ops/fftops.py``, ``ops/wave_io.py``,
``pipelines/compositing.py`` (with ``ops/imops.py:lrgb``),
``pipelines/plots.py`` and the CLI verbs that reach them (``satu``,
``rmgreen``, ``neutralize``, ``split``, ``fftd``, ``ffti``, ``rgbcomp``,
``align_rgb``, ``lightcurve``, ``regplot``).

Both packages get the same seeded NumPy inputs (at most 64 x 96).
Tolerances:

- colours, the FFT verbs, compositing and the plots are the same host
  NumPy float64 code: tolerance 0 against siriltpu (words, floats, file
  bytes), and ``c_colors.bin`` at the JAX test's 1e-13;
- ``.wave`` files: the reference's files (the ``.wave`` part of
  ``c_wavelets.bin``) read back exactly, the port's writer reproduces them
  byte for byte, and each package reads what the other writes;
- ``align_rgb`` registers on the device by integer DFT shifts: the same
  words as the JAX package's;
- ``lightcurve``: the magnitudes come from the f32 LM fit, which the two
  packages sum in other orders (tests/test_torch_starfind.py holds mag
  within 1e-3), so its ``.dat`` rows are held to 1e-3; its SVG's points
  move with them.
"""

import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.cli import commands as tcmd  # noqa: E402
from siriltpu_torch.cli import main as tmain  # noqa: E402
from siriltpu_torch.core.frame import Frame as TFrame  # noqa: E402
from siriltpu_torch.core.frame import Rect as TRect  # noqa: E402
from siriltpu_torch.core.frame import RegData as TRegData  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.ops import colors as tcol  # noqa: E402
from siriltpu_torch.ops import fftops as tfft  # noqa: E402
from siriltpu_torch.ops import imops as timops  # noqa: E402
from siriltpu_torch.ops import wave_io as twave  # noqa: E402
from siriltpu_torch.pipelines import compositing as tcomp  # noqa: E402
from siriltpu_torch.pipelines import plots as tplots  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
H, W = 48, 64


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.cli import commands, main
    from siriltpu.core import frame
    from siriltpu.io import fits, sequence
    from siriltpu.ops import colors, fftops, imops, photometry, wave_io
    from siriltpu.pipelines import compositing, plots
    from siriltpu.registration import onestar
    return SimpleNamespace(commands=commands, main=main, frame=frame, fits=fits,
                           sequence=sequence, colors=colors, fftops=fftops,
                           imops=imops, photometry=photometry, wave_io=wave_io,
                           compositing=compositing, plots=plots, onestar=onestar)


@pytest.fixture(autouse=True)
def own_tempdir(tmp_path, monkeypatch):
    """``wavelet``'s swap files and the undo history's go to this test's
    directory."""
    import tempfile
    swap = tmp_path / "swap"
    swap.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(swap))


def rgb_sky(seed: int, h: int = H, w: int = W, hi: int = 65535):
    """An RGB image with a background per channel, stars and noise."""
    rng = np.random.default_rng(seed)
    img = np.stack([np.full((h, w), v) for v in (1200.0, 900.0, 1500.0)])
    img = img + rng.normal(0, 40, img.shape)
    ys, xs = rng.integers(2, h - 2, 12), rng.integers(2, w - 2, 12)
    img[:, ys, xs] += rng.uniform(5000, 50000, (3, 12))
    return np.clip(np.rint(img * hi / 65535), 0, hi).astype(np.uint16)


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

    def take_u16s(self, n):
        a = np.frombuffer(self.buf, dtype="<u2", count=n, offset=self.off)
        self.off += 2 * n
        return a.copy()

    def take_f32s(self, n):
        a = np.frombuffer(self.buf, dtype="<f4", count=n, offset=self.off)
        self.off += 4 * n
        return a.copy()

    def take_bytes(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


# ------------------------------------------------------------------ colours

@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_colors.bin")),
                    reason="goldens not generated")
def test_colors_golden_vs_c():
    """c_colors.bin at the JAX test's tolerance: conversions to 1e-13, the
    SCNR, saturation and neutralization words exact."""
    r = _Reader("c_colors.bin")

    def close(got, want, ctx, tol=1e-13):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=str(ctx))

    for i in range(300):
        rr, gg, bb = r.take("ddd")
        close(tcol.rgb_to_hsl(rr, gg, bb), r.take("ddd"), ("hsl", i))
        h, s, l = tcol.rgb_to_hsl(rr, gg, bb)
        close(tcol.hsl_to_rgb(h, s, l), r.take("ddd"), ("hsl_rt", i))
        close(tcol.rgb_to_hsv(rr, gg, bb), r.take("ddd"), ("hsv", i))
        h, s, v = tcol.rgb_to_hsv(rr, gg, bb)
        close(tcol.hsv_to_rgb(h, s, v), r.take("ddd"), ("hsv_rt", i))
        x, y, z = r.take("ddd")
        close(tcol.rgb_to_xyz(rr, gg, bb), (x, y, z), ("xyz", i))
        L, A, B = r.take("ddd")
        close(tcol.xyz_to_lab(x, y, z), (L, A, B), ("lab", i))
        x2, y2, z2 = r.take("ddd")
        close(tcol.lab_to_xyz(L, A, B), (x2, y2, z2), ("lab_rt", i))
        close(tcol.xyz_to_rgb(x2, y2, z2), r.take("ddd"), ("xyz_rt", i))
    for _ in range(8):
        nx = r.take("H"); ny = r.take("H")
        typ = r.take("B"); preserve = r.take("B")
        amount = r.take("d")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        np.testing.assert_array_equal(
            tcol.scnr(img, typ, amount, preserve_lightness=bool(preserve)), out)
    for _ in range(4):
        nx = r.take("H"); ny = r.take("H")
        hmin, hmax = r.take("dd")
        preserve = r.take("B")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        np.testing.assert_array_equal(tcol.enhance_saturation(
            img, 0.4, h_min=hmin, h_max=hmax, preserve_background=bool(preserve)), out)
    nd = 0
    while not r.eof():
        nx = r.take("H"); ny = r.take("H")
        sx, sy, sw, sh = r.take("hhhh")
        img = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        out = r.take_u16s(3 * nx * ny).reshape(3, ny, nx)
        np.testing.assert_array_equal(
            tcol.background_neutralize(img, TRect(sx, sy, sw, sh)), out)
        nd += 1
    assert nd == 3


@pytest.mark.parametrize("conv", [("rgb_to_hsl", "hsl_to_rgb"),
                                  ("rgb_to_hsv", "hsv_to_rgb"),
                                  ("rgb_to_xyz", "xyz_to_lab", "lab_to_xyz",
                                   "xyz_to_rgb")])
def test_color_conversions_match_jax(jx, conv):
    """Each chain of conversions on random colours (greys, primaries and
    zeros among them): the same float64 values."""
    rng = np.random.default_rng(len(conv))
    rgb = rng.uniform(0, 1, (3, 500))
    rgb[:, :20] = rng.uniform(0, 1, 20)          # greys
    rgb[:, 20:30] = np.eye(3).repeat(4, axis=1)[:, :10]
    rgb[:, 30:35] = 0.0
    vals_t, vals_j = tuple(rgb), tuple(rgb)
    for name in conv:
        vals_t = getattr(tcol, name)(*vals_t)
        vals_j = getattr(jx.colors, name)(*vals_j)
        for a, b in zip(vals_t, vals_j):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("scnr_type", [0, 1, 2, 3])
@pytest.mark.parametrize("preserve", [True, False])
def test_scnr_matches_jax(jx, scnr_type, preserve):
    img = rgb_sky(10 + scnr_type)
    img[1] = np.clip(img[1].astype(int) + 3000, 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(
        tcol.scnr(img, scnr_type, 0.6, preserve_lightness=preserve),
        jx.colors.scnr(img, scnr_type, 0.6, preserve_lightness=preserve))


@pytest.mark.parametrize("band", [(0.0, 360.0, True), (20.0, 200.0, False),
                                  (300.0, 40.0, True)])
def test_enhance_saturation_matches_jax(jx, band):
    img = rgb_sky(20)
    hmin, hmax, preserve = band
    for coeff in (0.5, -0.3, 0.0):
        np.testing.assert_array_equal(
            tcol.enhance_saturation(img, coeff, h_min=hmin, h_max=hmax,
                                    preserve_background=preserve),
            jx.colors.enhance_saturation(img, coeff, h_min=hmin, h_max=hmax,
                                         preserve_background=preserve))


@pytest.mark.parametrize("case", ["selections", "manual", "eightbit"])
def test_neutralize_white_balance_and_extract_match_jax(jx, case):
    img = rgb_sky(30, hi=255 if case == "eightbit" else 65535)
    img[0, 4:12, 4:12] = 40000 if case != "eightbit" else 200
    white, black = TRect(4, H - 12, 8, 8), TRect(30, 2, 16, 12)
    jwhite, jblack = (jx.frame.Rect(*dataclass_vals(r)) for r in (white, black))
    np.testing.assert_array_equal(tcol.background_neutralize(img, black),
                                  jx.colors.background_neutralize(img, jblack))
    if case == "manual":
        got = tcol.white_balance(img, manual_kw=(1.1, 1.0, 0.8))
        want = jx.colors.white_balance(img, manual_kw=(1.1, 1.0, 0.8))
    else:
        got = tcol.white_balance(img, white_selection=white, black_selection=black)
        want = jx.colors.white_balance(img, white_selection=jwhite,
                                       black_selection=jblack)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tcol.extract_channels_rgb(img), jx.colors.extract_channels_rgb(img)):
        np.testing.assert_array_equal(a, b)


def dataclass_vals(rect):
    return rect.x, rect.y, rect.w, rect.h


# ---------------------------------------------------------------------- FFT

@pytest.mark.parametrize("shape", [(1, 32, 32), (1, 24, 40), (3, 20, 28)])
@pytest.mark.parametrize("order", ["centered", "regular"])
def test_fftd_ffti_match_jax(jx, shape, order):
    """fftd's modulus and phase words and header fields, and ffti's
    words, equal the JAX package's (non-square images take the (rx, ry)
    transpose quirk; odd halves the quadrant swap)."""
    rng = np.random.default_rng(shape[1] + shape[2])
    data = np.clip(rng.normal(3000, 500, shape), 0, 65535).astype(np.uint16)
    tm, tp = tfft.fftd(TFrame(data), order)
    jm, jp = jx.fftops.fftd(jx.frame.Frame(data), order)
    for t, j in ((tm, jm), (tp, jp)):
        np.testing.assert_array_equal(t.data, j.data)
        assert t.meta == j.meta
    back = tfft.ffti(tm, tp)
    np.testing.assert_array_equal(back.data, jx.fftops.ffti(jm, jp).data)
    if shape[1] == shape[2]:
        assert np.abs(back.data.astype(int) - data.astype(int)).max() <= 1


# ---------------------------------------------------------------- .wave files

@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_wavelets.bin")),
                    reason="goldens not generated")
def test_wave_io_golden_vs_c(tmp_path):
    """The reference's .wave files read back exactly, and the port's
    writer reproduces them byte for byte."""
    r = _Reader("c_wavelets.bin")
    assert r.take("i") == 440 and r.take("i") == 100
    ncases = 0
    while r.off < len(r.buf) - 63 * 4 - 63 * 2:
        nl = r.take("H"); nc = r.take("H")
        kind = r.take("B"); nplanes = r.take("B")
        r.take_u16s(nl * nc)
        want_planes = r.take_f32s(nplanes * nl * nc).reshape(nplanes, nl, nc)
        r.take_u16s(nplanes * nl * nc)     # extracted planes
        r.take_f32s(nplanes)               # weights
        r.take_u16s(nl * nc)               # reconstruction
        cbytes = r.take_bytes(r.take("q"))
        p = tmp_path / f"case{ncases}.wave"
        p.write_bytes(cbytes)
        planes, kind_rd = twave.wave_read(str(p))
        assert kind_rd == kind
        np.testing.assert_array_equal(planes, want_planes)
        q = tmp_path / f"case{ncases}_port.wave"
        twave.wave_write(str(q), want_planes, kind, name="")
        assert q.read_bytes() == cbytes
        ncases += 1
    assert ncases == 6


@pytest.mark.parametrize("kind", [1, 2])
def test_wave_files_cross_packages(jx, tmp_path, kind):
    """Each package reads what the other writes; both write the same bytes
    (the default name is the path, so both write the same path in turn)."""
    planes = np.random.default_rng(kind).normal(size=(3, 8, 10)).astype(np.float32)
    p = str(tmp_path / "t.wave")
    jx.wave_io.wave_write(p, planes, kind)
    jbytes = open(p, "rb").read()
    got, k = twave.wave_read(p)
    assert k == kind
    np.testing.assert_array_equal(got, planes)
    twave.wave_write(p, planes, kind)
    assert open(p, "rb").read() == jbytes
    got, k = jx.wave_io.wave_read(p)
    assert k == kind
    np.testing.assert_array_equal(got, planes)
    # the legacy private format is read too
    legacy = str(tmp_path / "old.wave")
    with open(legacy, "wb") as f:
        f.write(b"STPUWAV1" + struct.pack("<iiii", 3, 8, 10, kind))
        planes.tofile(f)
    got, k = twave.wave_read(legacy)
    assert k == kind
    np.testing.assert_array_equal(got, planes)


# --------------------------------------------------------------- compositing

def layer_pair(jx, planes, colors):
    """The same CompositionLayer list in both packages, carried across by
    the interop helpers."""
    jl = [jx.compositing.CompositionLayer(jx.frame.Frame(p), c)
          for p, c in zip(planes, colors)]
    return interop.composition_layers_from_fields(
        interop.composition_layers_to_fields(jl)), jl


@pytest.mark.parametrize("case", ["rgb", "clamp", "narrowband", "lum_hsl",
                                  "lum_hsv", "lum_lab", "lum_only"])
def test_compose_matches_jax(jx, case):
    rng = np.random.default_rng(len(case))
    planes = [np.clip(rng.normal(m, 3000, (1, H, W)), 0, 65535).astype(np.uint16)
              for m in (30000, 20000, 10000, 50000)]
    colors = {"rgb": [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
              "clamp": [(1, 0, 0), (1, 0, 0), (0, 0, 1), (0.5, 0.5, 0.5)],
              "narrowband": [tcomp.FILTER_COLORS[k] for k in ("Ha", "OIII", "SII", "Hb")],
              }.get(case, [(1, 0, 0), (0, 1, 0), (0, 0, 1)])
    tl, jl = layer_pair(jx, planes, colors)
    if case == "lum_only":
        tl, jl = [], []
    lum = planes[3] if case.startswith("lum") else None
    coloring = {"lum_hsv": tcomp.HSV, "lum_lab": tcomp.CIELAB}.get(case, tcomp.HSL)
    got = tcomp.compose(tl, luminance=None if lum is None else TFrame(lum),
                        coloring=coloring)
    want = jx.compositing.compose(
        jl, luminance=None if lum is None else jx.frame.Frame(lum), coloring=coloring)
    np.testing.assert_array_equal(got.data, want.data)


def test_wavelength_colors_and_lrgb_match_jax(jx):
    for nm in np.arange(350.0, 800.0, 7.5):
        assert tcomp.wavelength_to_color(nm) == jx.compositing.wavelength_to_color(nm)
    assert tcomp.FILTER_COLORS == jx.compositing.FILTER_COLORS
    r = np.full((8, 8), 40000, np.uint16)
    g = np.full((8, 8), 20000, np.uint16)
    b = np.full((8, 8), 20000, np.uint16)
    l = np.full((8, 8), 28000, np.uint16)
    l[0, 0] = 65535
    np.testing.assert_array_equal(timops.lrgb(l, r, g, b), jx.imops.lrgb(l, r, g, b))


@pytest.mark.parametrize("method", ["dft", "onestar"])
def test_align_rgb_matches_jax(jx, method):
    """The three channels of one image, shifted, aligned on the device:
    the same words as the JAX package's (integer shifts)."""
    from siriltpu.testing.synth import gaussian_star

    h = w = 96
    base = 800.0 + gaussian_star(h, w, 40.0, 50.0, 20000.0, 6.0, 6.0)
    base = np.clip(np.rint(base), 0, 65535).astype(np.uint16)
    rgb = np.stack([base, np.roll(base, (2, -3), (0, 1)),
                    np.roll(base, (-1, 2), (0, 1))])
    sel = None if method == "dft" else TRect(20, 26, 40, 40)
    jsel = None if sel is None else jx.frame.Rect(20, 26, 40, 40)
    got = tcomp.align_rgb(TFrame(rgb), method, sel, device="cpu")
    want = jx.compositing.align_rgb(jx.frame.Frame(rgb), method, jsel)
    np.testing.assert_array_equal(got.data, want.data)
    peaks = [np.unravel_index(np.argmax(got.data[c]), (h, w)) for c in range(3)]
    assert peaks[0] == peaks[1] == peaks[2]
    with pytest.raises(ValueError):
        tcomp.align_rgb(TFrame(base[None]), device="cpu")


# ----------------------------------------------------------------- plots

def test_registration_plots_match_jax(jx, tmp_path):
    frames = [np.random.default_rng(i).integers(0, 9, (1, 8, 8)).astype(np.uint16)
              for i in range(5)]
    tseq = tsequence.internal_sequence([TFrame(f) for f in frames])
    jseq = jx.sequence.internal_sequence([jx.frame.Frame(f) for f in frames])
    tseq.regparam[0] = [TRegData(quality=0.1 * i + 0.013, fwhm=3.0 + i / 7)
                        for i in range(5)]
    jseq.regparam[0] = [jx.frame.RegData(quality=0.1 * i + 0.013, fwhm=3.0 + i / 7)
                        for i in range(5)]
    np.testing.assert_array_equal(tplots.registration_curve(tseq, 0),
                                  jx.plots.registration_curve(jseq, 0))
    for pkg, seq, d in ((tplots, tseq, "t"), (jx.plots, jseq, "j")):
        rows = pkg.registration_curve(seq, 0)
        pkg.export_registration_dat(seq, str(tmp_path / f"{d}.dat"))
        pkg.plot_svg(rows, str(tmp_path / f"{d}.svg"), title="Registration quality")
        pkg.plot_svg(rows[:1], str(tmp_path / f"{d}1.svg"))
        with pytest.raises(ValueError):       # no rows: both packages refuse
            pkg.plot_svg(np.zeros((0, 3)), str(tmp_path / f"{d}0.svg"))
    for name in (".dat", ".svg", "1.svg"):
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()
    png = tplots.plot_png(tplots.registration_curve(tseq, 0), str(tmp_path / "r.png"))
    if png:        # matplotlib, imported only here, is optional
        assert os.path.getsize(png) > 0


def test_light_curve_plots_match_jax(jx, tmp_path):
    """The light-curve .dat and .svg of the same photometry results."""
    from siriltpu_torch.ops.photometry import Photometry
    from siriltpu_torch.registration.onestar import SeqPsfResult

    mags = -8.0 + 0.0137 * np.arange(6)
    tres = [SeqPsfResult(image_index=i, ok=i != 3,
                         photometry=Photometry(mag=m, s_mag=0.02 + i / 1000))
            for i, m in enumerate(mags)]
    jres = [jx.onestar.SeqPsfResult(image_index=i, ok=i != 3,
                                    photometry=jx.photometry.Photometry(
                                        mag=m, s_mag=0.02 + i / 1000))
            for i, m in enumerate(mags)]
    for pkg, res, d in ((tplots, tres, "t"), (jx.plots, jres, "j")):
        pkg.export_light_curve_dat(res, str(tmp_path / f"{d}.dat"))
        pkg.plot_svg(pkg.light_curve(res), str(tmp_path / f"{d}.svg"),
                     ylabel="magnitude", err_column=2, title="Light curve")
    for name in (".dat", ".svg"):
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()


# ---------------------------------------------------- the verbs, end to end

def pair_states(jx, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    return (jx.main.make_state(str(jdir)), tmain.make_state(str(tdir), device="cpu"),
            jdir, tdir)


def run_both(jx, js, ts, line):
    rj = jx.commands.process_command(js, line)
    rt = tcmd.process_command(ts, line)
    assert rt == rj == 0, (line, rt, rj)


def test_colour_verbs_match_jax(jx, tmp_path):
    """rgbcomp with a luminance, satu, rmgreen, neutralize, split and
    align_rgb through both command layers: the same words and files."""
    js, ts, jdir, tdir = pair_states(jx, tmp_path)
    sky = rgb_sky(40)
    for d in (jdir, tdir):
        for c, name in enumerate("RGB"):
            tfits.write_fits(str(d / f"{name}.fit"), TFrame(sky[c:c + 1]))
        tfits.write_fits(str(d / "L.fit"), TFrame(sky[1:2] // 2 + sky[0:1] // 2))
    for line in ("rgbcomp R G B L", "satu 0.5", "rmgreen 0", "rmgreen 2",
                 "boxselect 30 2 16 12", "neutralize", "align_rgb",
                 "split r g b", "savebmp colour"):
        run_both(jx, js, ts, line)
        np.testing.assert_array_equal(ts.image.data, js.image.data, err_msg=line)
    for name in ("r.fit", "g.fit", "b.fit"):
        assert tfits.read_fits(str(tdir / name)).data.tobytes() == \
            jx.fits.read_fits(str(jdir / name)).data.tobytes()
    assert (tdir / "colour.bmp").read_bytes() == (jdir / "colour.bmp").read_bytes()


def test_lightcurve_and_regplot_verbs_match_jax(jx, tmp_path):
    """lightcurve (seqpsf on the device) and regplot (after register dft):
    the .dat files and SVGs, to the module docstring's tolerance."""
    from siriltpu.testing.synth import gaussian_star, make_sequence_frames

    js, ts, jdir, tdir = pair_states(jx, tmp_path)
    for i in range(3):
        img = 500.0 + gaussian_star(64, 64, 32.0, 32.0, 20000.0, 6.0, 6.0)
        img = img + np.random.default_rng(i).normal(0, 4, img.shape)
        img = np.clip(np.rint(img), 0, 65535).astype(np.uint16)[None]
        for d in (jdir, tdir):
            tfits.write_fits(str(d / f"lc{i+1:02d}.fit"), TFrame(img))
    frames, _, _ = make_sequence_frames(3, 64, 64, seed=9)
    for i, f in enumerate(frames):
        for d in (jdir, tdir):
            tfits.write_fits(str(d / f"rp{i+1:02d}.fit"), TFrame(f))
    for line in ("seqload lc", "boxselect 2 2 60 60", "lightcurve",
                 "seqload rp", "boxselect 8 8 48 48", "register dft", "regplot"):
        run_both(jx, js, ts, line)
    rows_t = np.loadtxt(tdir / "light_curve.dat")
    rows_j = np.loadtxt(jdir / "light_curve.dat")
    assert rows_t.shape == rows_j.shape == (3, 3)
    np.testing.assert_array_equal(rows_t[:, 0], rows_j[:, 0])
    np.testing.assert_allclose(rows_t[:, 1:], rows_j[:, 1:], atol=1e-3)
    assert os.path.getsize(tdir / "light_curve.svg") > 500
    for name in ("registration.dat", "registration.svg"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
