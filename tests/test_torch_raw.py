"""Camera raw files of siriltpu_torch against siriltpu's: ``io/raw.py``
(the TIFF walker and every vendor decoder), ``io/rawproc.py`` and its
oracles in ``verify/oracle.py``, the writers of ``testing/``, the raw branch
of ``io/conversion.py`` and the native build of ``utils/native.py``.

All of it is host code (NumPy, and the same C++ sources built by each
package for itself), so every comparison is exact, tolerance 0: each
vendor file is written by both packages' writers and the two files are
equal byte for byte; each package decodes both files to the same plane,
equal to the planted one wherever the format is lossless; ``read_raw``
gives equal words for every debayer method and for non-default libraw
knobs; the FITS files of a conversion are equal but for their ``DATE``
card. Raw frames stay near 64 x 96: the Python encoders loop per sample.
"""

import hashlib
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core import config as tconfig  # noqa: E402
from siriltpu_torch.io import conversion as tconv  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import raw as traw  # noqa: E402
from siriltpu_torch.io import rawproc as trawproc  # noqa: E402
from siriltpu_torch.testing import arw, cr2, crw, mrw, nef, orf, pef, raf, rw2  # noqa: E402
from siriltpu_torch.utils import native as tnative  # noqa: E402
from siriltpu_torch.verify import oracle as toracle  # noqa: E402
from test_raw import _write_tiff_raw, encode_lossless_jpeg, write_dng  # noqa: E402

TESTING = SimpleNamespace(arw=arw, cr2=cr2, crw=crw, mrw=mrw, nef=nef, orf=orf,
                          pef=pef, raf=raf, rw2=rw2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    from siriltpu.core import config
    from siriltpu.io import conversion, fits, raw, rawproc
    from siriltpu.testing import arw, cr2, crw, mrw, nef, orf, pef, raf, rw2
    from siriltpu.verify import oracle
    return SimpleNamespace(config=config, conversion=conversion, fits=fits,
                           raw=raw, rawproc=rawproc, oracle=oracle,
                           testing=SimpleNamespace(arw=arw, cr2=cr2, crw=crw,
                                                   mrw=mrw, nef=nef, orf=orf,
                                                   pef=pef, raf=raf, rw2=rw2))


def fits_bytes(path) -> bytes:
    """A FITS file's bytes with the value of its DATE card blanked."""
    raw = bytearray(open(path, "rb").read())
    for off in range(0, len(raw), 80):
        if raw[off:off + 8] == b"DATE    ":
            raw[off + 10:off + 30] = b" " * 20
            break
    return bytes(raw)


def rand(bits, h=64, w=96, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << bits, (h, w)).astype(np.uint16)


def smooth(h, w, seed, bits=12):
    """Sensor-like rows with bounded steps (what CRW's table 0 encodes)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(300, 700) + np.cumsum(rng.integers(-9, 10, (h, w)), axis=1)
    return np.clip(img, 0, (1 << bits) - 1).astype(np.uint16)


def arw_raster(h=8, w=96, seed=7):
    """Sony blocks whose 16 same-parity pixels span <= 127 values (exact)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 0x7FF - 127, (h, w // 32, 2))
    pix = np.repeat(base.reshape(h, -1), 16, axis=1).reshape(h, w // 32, 2, 16)
    pix = pix + rng.integers(0, 128, pix.shape)
    raster = np.zeros((h, w), np.int64)
    cols = (32 * np.arange(w // 32)[:, None] + 2 * np.arange(16)[None, :]).ravel()
    raster[:, cols] = pix[:, :, 0, :].reshape(h, -1)
    raster[:, cols + 1] = pix[:, :, 1, :].reshape(h, -1)
    return raster


NEF_PTS = ((np.arange(257) / 256.0) ** 0.45 * 60000).astype(np.uint16)

# name -> (file name, writer(testing, path) -> the plane a decoder returns:
#          the planted one where the format is exact, else the encoder's own
#          tracked decode)
CASES = {
    "cr2": ("a.cr2", lambda t, p: (t.cr2.write_cr2(p, rand(14)), rand(14))[1]),
    "cr2_sliced": ("s.cr2", lambda t, p: (t.cr2.write_cr2(
        p, rand(14, 48, 120, 11), slices=(2, 48, 24)), rand(14, 48, 120, 11))[1]),
    "cr2_crop": ("c.cr2", lambda t, p: (t.cr2.write_cr2(
        p, rand(14, 72, 104, 12), borders=(8, 6, 95, 65)),
        rand(14, 72, 104, 12)[6:66, 8:96])[1]),
    "cr2_extreme": ("e.cr2", lambda t, p: (t.cr2.write_cr2(
        p, EXTREME, precision=16), EXTREME)[1]),
    "nef_lossless12": ("a.nef", lambda t, p: t.nef.write_nef(
        p, rand(12, 32, 48, 42), bps=12, lossless=True)),
    "nef_lossless14": ("b.nef", lambda t, p: t.nef.write_nef(
        p, rand(14, 32, 48, 44), bps=14, lossless=True)),
    "nef_lossy_split": ("c.nef", lambda t, p: t.nef.write_nef(
        p, rand(12, 40, 32, 34), bps=12, lossless=False, curve_pts=NEF_PTS,
        split=20)),
    "nef_direct_curve": ("d.nef", lambda t, p: t.nef.write_nef(
        p, rand(12, 12, 16, 36), bps=12, lossless=False,
        direct_curve=(np.arange(4096, dtype=np.uint32) * 16).astype(np.uint16))),
    "nef_d100": ("e.nef", lambda t, p: t.nef.write_nef(
        p, rand(12, 10, 12, 37), bps=12, lossless=False, d100_skip=True)),
    "pef12": ("a.pef", lambda t, p: (t.pef.write_pef(p, rand(12, 32, 48, 52), bps=12),
                                     rand(12, 32, 48, 52))[1]),
    "pef14_aoc": ("b.pef", lambda t, p: (t.pef.write_pef(
        p, rand(14, 16, 20, 43), bps=14, makernote="AOC"), rand(14, 16, 20, 43))[1]),
    "pef_lens": ("c.pef", lambda t, p: (t.pef.write_pef(
        p, rand(12, 12, 16, 44), bps=12, lens=[9, 8, 7, 6, 5, 4, 3, 3, 3, 4, 8, 10, 10]),
        rand(12, 12, 16, 44))[1]),
    "orf": ("a.orf", lambda t, p: (t.orf.write_orf(p, rand(12, 32, 48, 50)),
                                   rand(12, 32, 48, 50))[1]),
    "orf_smooth": ("b.orf", lambda t, p: (t.orf.write_orf(p, GRADIENT), GRADIENT)[1]),
    "rw2": ("a.rw2", lambda t, p: t.rw2.write_rw2(p, rand(12, 32, 42, 60))),
    "rw2_crop": ("b.rw2", lambda t, p: t.rw2.write_rw2(
        p, (100 + np.mgrid[0:20, 0:28][0] * 17 + np.mgrid[0:20, 0:28][1] * 13
            ).astype(np.uint16), borders=(2, 4, 18, 26))),
    "mrw_packed": ("a.mrw", lambda t, p: (t.mrw.write_mrw(p, rand(12, 24, 34, 61), packed=True),
                                          rand(12, 24, 34, 61))[1]),
    "mrw_unpacked": ("b.mrw", lambda t, p: (t.mrw.write_mrw(
        p, rand(12, 10, 18, 62), packed=False), rand(12, 10, 18, 62))[1]),
    "raf": ("a.raf", lambda t, p: (t.raf.write_raf(p, rand(14, 20, 30, 63)),
                                   rand(14, 20, 30, 63))[1]),
    "crw_lowbits": ("a.crw", lambda t, p: (t.crw.write_crw(p, smooth(16, 32, 5), lowbits=True),
                                           smooth(16, 32, 5))[1]),
    "crw_crop": ("b.crw", lambda t, p: (t.crw.write_crw(
        p, smooth(24, 48, 7), lowbits=True, crop=(4, 2, 43, 21)),
        smooth(24, 48, 7)[2:22, 4:44])[1]),
    "arw2": ("a.arw", lambda t, p: (t.arw.write_arw(p, t.arw.encode_arw2(arw_raster()), 8, 96),
                                    (arw_raster() << 3).astype(np.uint16))[1]),
}
EXTREME = np.zeros((8, 16), np.uint16)
EXTREME[::2, ::2] = 65535
EXTREME[1::2, 1::2] = 32768
GRADIENT = ((np.mgrid[0:40, 0:56][0] * 13 + np.mgrid[0:40, 0:56][1] * 7) % 4096
            ).astype(np.uint16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vendor_writer_and_decoder_match_jax(jx, tmp_path, case):
    """Both packages' writers make the same file; each package decodes
    either file to the same plane and pattern (and flips it bottom-up
    alike); that plane is the planted one where the format is exact, else
    the encoder's own tracked decode."""
    name, write = CASES[case]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj, pt = str(tmp_path / "j" / name), str(tmp_path / "t" / name)
    want_j = write(jx.testing, pj)
    want_t = write(TESTING, pt)
    np.testing.assert_array_equal(want_t, want_j)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    ref = jx.raw.read_raw_cfa(pj)
    for path in (pt, pj):
        got = traw.read_raw_cfa(path)
        assert got.meta["bayer_pattern"] == ref.meta["bayer_pattern"]
        np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.data[0][::-1], want_t)


@pytest.mark.parametrize("kind", ["dng16", "dng12_strips", "dng14_be", "dng8",
                                  "dng_tiled", "dng_lj92", "dng_lj92_tiled",
                                  "tiff_nef14", "tiff_arw12"])
def test_tiff_raws_match_jax(jx, tmp_path, kind):
    """DNG (packed, strips, tiles, big-endian, lossless JPEG through the
    native lj92) and uncompressed TIFF-strip vendor raws: the same plane
    and pattern from both packages, the planted one."""
    bits = {"dng12_strips": 12, "dng14_be": 14, "dng8": 8, "tiff_nef14": 14,
            "tiff_arw12": 12}.get(kind, 16)
    cfa = rand(bits, 24, 32, seed=hash(kind) % 1000)
    if kind.startswith("tiff"):
        p = str(tmp_path / ("x.nef" if kind == "tiff_nef14" else "x.arw"))
        _write_tiff_raw(p, cfa, bits=bits, strips=3 if bits == 14 else 1)
    else:
        p = str(tmp_path / "x.dng")
        kw = {"dng12_strips": dict(rows_per_strip=4),
              "dng14_be": dict(endian=">", rows_per_strip=2),
              "dng_tiled": dict(tiled=True),
              "dng_lj92": dict(compression=7, predictor=6, rows_per_strip=8),
              "dng_lj92_tiled": dict(compression=7, tiled=True, jcomp=2)}.get(kind, {})
        write_dng(p, cfa, pattern="GBRG", bits=bits, **kw)
    got, want = traw.read_raw_cfa(p), jx.raw.read_raw_cfa(p)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.data[0], cfa[::-1])


@pytest.mark.parametrize("bits,predictor,ncomp,pt", [
    (16, 1, 1, 0), (14, 5, 1, 0), (12, 7, 1, 0), (16, 4, 2, 0), (12, 2, 2, 0),
    (14, 1, 1, 2)])
def test_lj92_decoder_matches_jax_and_libavcodec(jx, bits, predictor, ncomp, pt):
    """The port's build of native/lj92.cpp decodes SOF3 streams (every
    predictor family, two components, a point transform) as the JAX
    package's does and, where the libav bridge builds, one component as
    libavcodec's mjpeg decoder does on the same bytes."""
    import ctypes
    img = rand(bits, 12, 24 * ncomp, seed=bits + predictor) & ~np.uint16((1 << pt) - 1)
    buf = encode_lossless_jpeg(img, bits, predictor=predictor, ncomp=ncomp, pt=pt)
    got, nc = traw.decode_lossless_jpeg(buf, img.size)
    want, nc_j = jx.raw.decode_lossless_jpeg(buf, img.size)
    assert nc == nc_j == ncomp
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    lib = tnative.load_film_native()
    if lib is None or ncomp != 1 or pt:
        return
    fn = lib.lj92_av_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
                   ctypes.c_long, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    out = np.zeros(img.size, np.uint16)
    ww, hh = ctypes.c_int(0), ctypes.c_int(0)
    assert fn(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
              out.size, ctypes.byref(ww), ctypes.byref(hh)) == 0
    # libavcodec scales grays of fewer than 16 bits up by a left shift
    np.testing.assert_array_equal(out.reshape(img.shape) >> (16 - bits), img)


@pytest.mark.parametrize("case", ["arw2_lossy", "arw2_scalar", "tone_curve"])
def test_sony_decoder_matches_jax(jx, case):
    """The vectorized ARW2 decoder and the SR2 tone curve: equal to the JAX
    package's, and the decoder to the per-pixel scalar port."""
    if case == "tone_curve":
        for breaks in (None, [b << 2 for b in (800, 1600, 2400, 3200)]):
            np.testing.assert_array_equal(traw.sony_tone_curve(breaks),
                                          jx.raw.sony_tone_curve(breaks))
        return
    rng = np.random.default_rng(8)
    h, w = 4, 95
    if case == "arw2_lossy":
        raster = rng.integers(0, 0x800, (h, w))
        strip = arw.encode_arw2(raster)
        assert strip == jx.testing.arw.encode_arw2(raster)
    else:
        strip = rng.integers(0, 256, h * w, dtype=np.uint8).tobytes()
    curve = traw.sony_tone_curve((0, 0, 2048 << 2, 4095 << 2))
    got = traw.decode_arw2(strip, h, w, curve)
    np.testing.assert_array_equal(got, jx.raw.decode_arw2(strip, h, w, curve))
    np.testing.assert_array_equal(got, arw.decode_arw2_scalar(strip, h, w, curve))


@pytest.mark.parametrize("case", ["super_ccd", "xtrans", "not_mrw", "not_crw",
                                  "compressed_tiff", "dng_compression_8",
                                  "dng_empty", "dng_truncated", "unknown_ext"])
def test_refusals_match_jax(jx, tmp_path, case):
    """What the reference refuses, both packages refuse with the same
    exception type and message."""
    p = str(tmp_path / {"super_ccd": "s.raf", "xtrans": "x.raf", "not_mrw": "b.mrw",
                        "not_crw": "b.crw", "compressed_tiff": "c.nef",
                        "unknown_ext": "x.x3f"}.get(case, "c.dng"))
    if case in ("super_ccd", "xtrans"):
        raf.write_raf(p, np.zeros((4, 6), np.uint16), **{case: True})
    elif case in ("not_mrw", "not_crw", "unknown_ext"):
        open(p, "wb").write(b"II*\x00" + bytes(64))
    elif case == "compressed_tiff":
        hdr = b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 2)
        hdr += struct.pack("<HHI", 0x0100, 4, 1) + struct.pack("<I", 64)
        hdr += struct.pack("<HHI", 0x0103, 3, 1) + struct.pack("<HH", 34713, 0)
        open(p, "wb").write(hdr + struct.pack("<I", 0))
    elif case == "dng_empty":
        open(p, "wb").write(b"")
    else:
        write_dng(p, np.zeros((8, 8), np.uint16))
        buf = bytearray(open(p, "rb").read())
        if case == "dng_truncated":
            buf = buf[:40]
        else:
            for i in range(struct.unpack_from("<H", buf, 8)[0]):
                if struct.unpack_from("<H", buf, 10 + 12 * i)[0] == 259:
                    struct.pack_into("<H", buf, 10 + 12 * i + 8, 8)
        open(p, "wb").write(bytes(buf))
    with pytest.raises(Exception) as want:
        jx.raw.read_raw_cfa(p)
    with pytest.raises(want.type) as got:
        traw.read_raw_cfa(p)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- read_raw

@pytest.mark.parametrize("method", ["bilinear", "nearest", "super_pixel", "vng", "ahd"])
def test_read_raw_debayer_matches_jax(jx, tmp_path, method):
    """The demosaiced path (flip, debayer, flip back) for every method, on
    a frame small enough for the host debayer in both packages."""
    p = str(tmp_path / "a.dng")
    write_dng(p, rand(16, 32, 48, seed=3), pattern="GRBG")
    got = traw.read_raw(p, method=method, device="cpu")
    want = jx.raw.read_raw(p, method=method)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.data, want.data)


SETTINGS = {
    "default": {},
    "user_mul_gamma_bilinear": dict(raw_auto_mul=False, raw_mul_0=1.8, raw_mul_2=1.4,
                                    raw_gamm_0=2.222, raw_gamm_1=4.5, raw_bright=1.2,
                                    raw_user_qual=0),
    "auto_wb_vng": dict(raw_auto_wb=True, raw_user_qual=2, raw_gamm_0=1.8,
                        raw_gamm_1=0.0),
    "cam_wb_ppg_black": dict(raw_cam_wb=True, raw_user_qual=3, raw_user_black=True,
                             raw_bright=0.5, raw_gamm_0=0.8, raw_gamm_1=2.0),
}


@pytest.mark.parametrize("knobs", sorted(SETTINGS))
def test_read_raw_with_settings_matches_jax(jx, tmp_path, knobs):
    """libraw's knobs around the debayer (white balance, brightness, gamma,
    user_qual's method) give the same words in both packages."""
    p = str(tmp_path / "a.cr2")
    cr2.write_cr2(p, rand(14, 48, 64, seed=9))
    got = traw.read_raw(p, settings=tconfig.Settings(**SETTINGS[knobs]), device="cpu")
    want = jx.raw.read_raw(p, settings=jx.config.Settings(**SETTINGS[knobs]))
    np.testing.assert_array_equal(got.data, want.data)


def test_read_raw_large_ahd_runs_on_device(jx, tmp_path, monkeypatch):
    """With the default settings (user_qual 1, AHD) a frame of 2^20 pixels
    debayers through ``ahd_device`` on the device given: the words equal
    that call composed by hand, and the JAX package's NumPy AHD on all but
    1e-5 of them (the float32 colour transform's knife-edges, where NumPy's
    ``tensordot`` sums in another order at this size; ``chip_smoke.py``
    holds the card to the host so). Without a device it is refused."""
    from siriltpu_torch.ops import demosaic as tdemosaic
    h, w = 1024, 1024
    rng = np.random.default_rng(4)
    cfa = np.clip(rng.normal(3000, 400, (h, w)), 0, 16383).astype(np.uint16)
    p = str(tmp_path / "big.dng")
    write_dng(p, cfa, pattern="RGGB")
    calls = []
    real = tdemosaic.ahd_device
    monkeypatch.setattr(tdemosaic, "ahd_device",
                        lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
    got = traw.read_raw(p, settings=tconfig.Settings(), device="cpu")
    assert calls == ["cpu"]
    by_hand = real(cfa, "RGGB", device="cpu")[:, ::-1]
    np.testing.assert_array_equal(got.data, by_hand)
    want = jx.raw.read_raw(p, settings=jx.config.Settings())
    assert (got.data != want.data).mean() <= 1e-5
    with pytest.raises(ValueError, match="pass device="):
        traw.read_raw(p, settings=tconfig.Settings(), device=None)


# ----------------------------------------------------------------- rawproc

@pytest.mark.parametrize("gamm0,gamm1,bright", [(1.0, 1.0, 1.0), (2.222, 4.5, 1.0),
                                                (1.8, 0.0, 1.0), (2.2, 4.5, 1.7),
                                                (0.8, 2.0, 0.5)])
def test_gamma_curve_matches_oracle_and_jax(jx, gamm0, gamm1, bright):
    got = trawproc.output_curve(gamm0, gamm1, bright)
    args = (1.0 / gamm0, gamm1, (0x2000 << 3) / bright)
    np.testing.assert_array_equal(got, toracle.libraw_gamma_curve(*args))
    np.testing.assert_array_equal(got, jx.rawproc.output_curve(gamm0, gamm1, bright))
    np.testing.assert_array_equal(toracle.libraw_gamma_curve(*args),
                                  jx.oracle.libraw_gamma_curve(*args))


def test_gamma_oracle_wraps_as_the_c_code(jx, monkeypatch):
    """Where dcraw's value reaches 1.0, the C stores ``0x10000`` into an
    unsigned short, which wraps to 0: the port's oracle does so
    (``int(0x10000 * v) & 0xffff``) where the JAX package's raises
    ``OverflowError``, and the production curve clips to 65535. No valid
    knob reaches it (the log branch, ``pwr = 0``, without a toe, would
    first take the log of 0), so ``math.log(0)`` is made finite here."""
    import math
    log = math.log
    monkeypatch.setattr(math, "log", lambda x: -1e300 if x == 0 else log(x))
    args = (0.0, 0.5, float(0x2000 << 3))
    with pytest.raises(OverflowError):
        jx.oracle.libraw_gamma_curve(*args)
    np.testing.assert_array_equal(toracle.libraw_gamma_curve(*args),
                                  np.zeros(0x10000, np.uint16))
    np.testing.assert_array_equal(trawproc.gamma_curve(*args),
                                  np.full(0x10000, 65535, np.uint16))


def _cfa(h=48, w=64, seed=3):
    cfa = np.random.default_rng(seed).integers(100, 16000, (h, w)).astype(np.uint16)
    cfa[9:12, 9:12] = 65530
    cfa[0, 5] = 0
    return cfa


@pytest.mark.parametrize("pattern", ["RGGB", "BGGR", "GBRG", "GRBG"])
def test_auto_wb_matches_oracle_and_jax(jx, pattern):
    cfa = _cfa()
    got = trawproc.auto_wb_multipliers(cfa, pattern, maximum=65535, black=96)
    np.testing.assert_array_equal(got, jx.rawproc.auto_wb_multipliers(
        cfa, pattern, maximum=65535, black=96))
    want = toracle.libraw_auto_wb(cfa, pattern, maximum=65535, black=96)
    np.testing.assert_array_equal(want, jx.oracle.libraw_auto_wb(
        cfa, pattern, maximum=65535, black=96))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("pattern,black", [("RGGB", 0), ("GBRG", 256)])
def test_scale_cfa_matches_oracle_and_jax(jx, pattern, black):
    cfa = _cfa(seed=11)
    pre = np.array([2.1, 1.0, 1.6, 0.0])
    smul = trawproc.scale_multipliers(pre, maximum=16383, black=black)
    np.testing.assert_array_equal(smul, jx.rawproc.scale_multipliers(
        pre, maximum=16383, black=black))
    got = trawproc.scale_cfa(cfa, pattern, smul, black=black)
    np.testing.assert_array_equal(got, jx.rawproc.scale_cfa(cfa, pattern, smul, black=black))
    want = toracle.libraw_scale_colors(cfa, pattern, pre, maximum=16383, black=black)
    np.testing.assert_array_equal(got, want)


def test_choose_multipliers_matches_jax(jx):
    cfa = _cfa(seed=7)
    user = (1.9, 1.0, 1.3, 1.0)
    for kw in (dict(user_mul=user), dict(user_mul=user, use_auto_wb=True, pattern="RGGB"),
               dict(user_mul=user, use_auto_wb=True, use_camera_wb=True,
                    cam_mul=(2.4, 1.0, 1.5, 1.0), pattern="RGGB"),
               dict(use_camera_wb=True, cam_mul=None, pattern="RGGB")):
        np.testing.assert_array_equal(trawproc.choose_multipliers(cfa=cfa, **kw),
                                      jx.rawproc.choose_multipliers(cfa=cfa, **kw))
    assert trawproc.USER_QUAL_METHODS == jx.rawproc.USER_QUAL_METHODS


# -------------------------------------------------------------- conversion

@pytest.mark.parametrize("debayer", [False, True])
def test_convert_raw_dir_matches_jax(jx, tmp_path, debayer):
    """``convert_dir`` of a folder of CR2, NEF, PEF, ORF, RW2, MRW, RAF, CRW
    and DNG files: the same count, log and FITS files (but their DATE
    card) from both packages, CFA or debayered."""
    dirs = []
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        cr2.write_cr2(str(d / "IMG_0001.CR2"), rand(14, 32, 48, 30))
        nef.write_nef(str(d / "DSC_0002.NEF"), rand(14, 32, 48, 31), bps=14, lossless=True)
        pef.write_pef(str(d / "IMGP0003.PEF"), rand(12, 32, 48, 32), bps=12)
        orf.write_orf(str(d / "P0004.ORF"), rand(12, 32, 48, 33))
        rw2.write_rw2(str(d / "P0005.RW2"), rand(12, 32, 42, 34))
        mrw.write_mrw(str(d / "PICT0006.MRW"), rand(12, 32, 48, 35))
        raf.write_raf(str(d / "DSCF0007.RAF"), rand(14, 32, 48, 36))
        crw.write_crw(str(d / "CRW_0008.CRW"), smooth(32, 48, 37), lowbits=True)
        write_dng(str(d / "L0009.dng"), rand(16, 32, 48, 38), pattern="BGGR")
        dirs.append(d)
    nj = jx.conversion.convert_dir(str(dirs[0]), "light", debayer=debayer)
    nt = tconv.convert_dir(str(dirs[1]), "light", debayer=debayer, device="cpu")
    assert nt == nj == 9
    names = sorted(n for n in os.listdir(dirs[0]) if n.startswith("light"))
    assert names == sorted(n for n in os.listdir(dirs[1]) if n.startswith("light"))
    for n in names:
        assert fits_bytes(dirs[1] / n) == fits_bytes(dirs[0] / n), n
        assert tfits.read_fits(str(dirs[1] / n)).nlayers == (3 if debayer else 1)


# ------------------------------------------------------------ native build

def test_native_build_writes_under_build_only(tmp_path):
    """The port builds its native libraries under ``siriltpu_torch/_build/``
    by a name keyed on the sources and flags, and writes nothing under
    ``native/``, which it only reads. (The JAX package may build its own
    ``native/*.so`` meanwhile, in another worker: the sources are hashed,
    and no library of the port's naming may appear there.)"""
    def tree():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(tnative.NATIVE_DIR.glob("*.cpp"))}
    before = tree()
    lib = tnative.load_native()
    assert lib is not None
    path = os.path.realpath(lib._name)
    build_dir = os.path.realpath(str(tnative.BUILD_DIR))
    assert os.path.dirname(path) == build_dir
    assert os.path.basename(path).startswith("libsirilnative_")
    film = tnative.load_film_native()
    if film is not None:
        assert os.path.dirname(os.path.realpath(film._name)) == build_dir
    assert tree() == before
    assert not list(tnative.NATIVE_DIR.glob("libsiril*_*.so"))
    srcs = sorted(tnative.NATIVE_DIR.glob("*.cpp"))
    core = [s for s in srcs if s.name != "film_codec.cpp"]
    assert os.path.basename(path) == tnative.library_path(
        "libsirilnative", core, tnative.CXX_FLAGS).name
    # a change of a source or a flag names another library
    assert tnative.library_path("libsirilnative", core, ("-O2",)).name != \
        os.path.basename(path)
