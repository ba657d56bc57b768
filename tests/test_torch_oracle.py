"""The NumPy oracle of siriltpu_torch (``verify/oracle.py``) against
siriltpu's, and the port against the compiled reference's goldens that
no other port test reads.

The oracle is host NumPy copied with its arithmetic order, so every
function is held to the JAX package's at tolerance 0, on the rejection and
normalization modes the JAX tests use (tests/test_stack_basic.py,
tests/test_rejection.py, tests/test_stats.py). The goldens
(tests/goldens/*.bin, from the reference's own C) are read as
tests/test_c_goldens.py reads them, at its tolerances: c_rejection.bin
through ``stack_mean_rejection`` exactly; c_statistics.bin through
``ops/stats.py:statistics``, its integer fields exactly and its float
fields within test_c_goldens.py's relative bounds (1e-13 to 1e-9: the C
accumulates in long double); c_ser.bin and c_seqfile.bin byte for byte
and field for field.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu.testing.synth import make_sequence_frames  # noqa: E402
from siriltpu.verify import oracle as joracle  # noqa: E402

from siriltpu_torch.verify import oracle as toracle  # noqa: E402

from test_c_goldens import GOLDEN_DIR, REJ_NAMES, Reader, _read_rejection  # noqa: E402

REJECTIONS = ["sigma", "sigmedian", "winsorized", "linearfit", "percentile", "none"]
NORMS = ["none", "additive", "multiplicative", "additive_scaling",
         "multiplicative_scaling"]


def random_vectors(f, p, seed, outliers=True):
    """tests/test_rejection.py's vectors: noise near 1000 with 8% outliers."""
    rng = np.random.default_rng(seed)
    base = rng.normal(1000, 50, size=(f, p))
    if outliers:
        mask = rng.random((f, p)) < 0.08
        base = np.where(mask, rng.uniform(0, 20000, size=(f, p)), base)
    return np.clip(np.rint(base), 0, 65535).astype(np.uint16)


def sig_of(rejection):
    return (0.2, 0.1) if rejection == "percentile" else (2.5, 2.5)


def coeffs_for(f: int, seed: int):
    """(offset, mul, scale) as compute_normalization makes them, from
    seeded locations and scales."""
    rng = np.random.default_rng(seed)
    ref = SimpleNamespace(location=1500.0, scale=60.0)
    stats = [SimpleNamespace(location=float(rng.uniform(1200, 1800)),
                             scale=float(rng.uniform(40, 80))) for _ in range(f)]
    return ref, stats


# ------------------------------------------------------- sum, max and min

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("method", ["sum", "max", "min"])
def test_basic_stacks_match_jax(method, seed):
    frames, _, shifts = make_sequence_frames(7, 20, 24, seed=40 + seed)
    if seed:   # a dim sequence: the sum stays below 65535, no rescale
        frames = (frames // 16).astype(np.uint16)
    got = getattr(toracle, f"stack_{method}")(frames, shifts)
    want = getattr(joracle, f"stack_{method}")(frames, shifts)
    if method == "sum":
        (got, hi), (want, hi_w) = got, want
        assert hi == hi_w and (hi == 65535) == (seed == 0)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- rejection

@pytest.mark.parametrize("rejection", REJECTIONS)
def test_reject_pixel_matches_jax(rejection):
    vals = random_vectors(15, 64, seed=REJECTIONS.index(rejection) + 1)
    for j in range(vals.shape[1]):
        got = toracle.reject_pixel(vals[:, j], rejection, sig_of(rejection))
        want = joracle.reject_pixel(vals[:, j], rejection, sig_of(rejection))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rejection,norm", [
    ("sigma", "none"), ("sigmedian", "additive"), ("winsorized", "additive_scaling"),
    ("linearfit", "multiplicative"), ("percentile", "multiplicative_scaling"),
    ("none", "none")])
def test_stack_mean_rejection_matches_jax(rejection, norm):
    """tests/test_rejection.py:98-131's stacks: shifts, an outlier, and
    normalization coefficients."""
    rng = np.random.default_rng(11)
    f, c, h, w = 9, 1, 8, 9
    frames = np.clip(rng.normal(2000, 100, (f, c, h, w)), 0, 65535).astype(np.uint16)
    frames[3, 0, 5, 5] = 60000
    shifts = rng.integers(-2, 3, size=(f, 2)).astype(np.int32)
    ref, stats = coeffs_for(f, 5)
    coeffs = toracle.compute_normalization(ref, stats, norm)
    got = toracle.stack_mean_rejection(frames, shifts, rejection, sig_of(rejection),
                                       norm, coeffs)
    want = joracle.stack_mean_rejection(frames, shifts, rejection, sig_of(rejection),
                                        norm, coeffs)
    np.testing.assert_array_equal(got, want)
    assert got[0, 5, 5] < 3000 or rejection == "none"


@pytest.mark.parametrize("f", [9, 10])
@pytest.mark.parametrize("norm", ["none", "additive", "multiplicative_scaling"])
def test_stack_median_matches_jax(f, norm):
    rng = np.random.default_rng(17)
    frames = np.clip(rng.normal(3000, 500, (f, 1, 8, 9)), 0, 65535).astype(np.uint16)
    ref, stats = coeffs_for(f, 6)
    coeffs = None if norm == "none" else toracle.compute_normalization(ref, stats, norm)
    got = toracle.stack_median(frames, norm, coeffs)
    np.testing.assert_array_equal(got, joracle.stack_median(frames, norm, coeffs))


@pytest.mark.parametrize("norm", NORMS)
def test_compute_normalization_matches_jax(norm):
    ref, stats = coeffs_for(6, 7)
    stats[2] = SimpleNamespace(location=0.0, scale=0.0)   # the zero guards
    got = toracle.compute_normalization(ref, stats, norm)
    want = joracle.compute_normalization(ref, stats, norm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def noise_cases():
    """tests/test_stats.py:185's images: noise, constant runs, nulls, a
    mostly null row, tiny widths."""
    rng = np.random.default_rng(42)
    img = np.clip(rng.normal(1200, 80, (30, 50)), 0, 65535).astype(np.uint16)
    img2 = img.copy()
    img2[5:9, 10:40] = 777
    img2[12, ::2] = 777
    img3 = img.copy()
    img3[rng.random(img.shape) < 0.15] = 0
    img4 = img.copy()
    img4[3, 8:] = 0
    return [(img, False), (img2, False), (img3, True), (img4, True),
            (img[:2, :4].copy(), False), (np.array([[5, 0, 9]], dtype=np.uint16), True)]


@pytest.mark.parametrize("case", range(6))
def test_fn_noise5_matches_jax_and_stats(case):
    from siriltpu_torch.ops.stats import img_stats_noise

    m, nc = noise_cases()[case]
    got = toracle.fn_noise5(m, nullcheck=nc)
    assert got == joracle.fn_noise5(m, nullcheck=nc)
    st = img_stats_noise(m, nullcheck=nc)
    assert st[:3] == got[:3]


# --------------------------------------------------------------- goldens

def test_rejection_oracle_vs_c():
    """tests/test_c_goldens.py:148 with the port's oracle: every record of
    the compiled C's rejection switch, exactly."""
    recs = _read_rejection()
    assert len(recs) > 2000
    bad = []
    for t, kind, n, sig0, sig1, vec, mean, rej0, rej1 in recs:
        got = toracle.stack_mean_rejection(
            vec.reshape(n, 1, 1, 1), np.zeros((n, 2), np.int64),
            REJ_NAMES[t].replace("_masked", ""), (sig0, sig1))
        if int(got[0, 0, 0]) != int(mean):
            bad.append((REJ_NAMES[t], n, sig0, sig1, int(got[0, 0, 0]), int(mean)))
    assert not bad, f"{len(bad)} oracle mismatches vs C: {bad[:5]}"


def test_statistics_vs_c():
    """tests/test_c_goldens.py:187 with the port's statistics, at its
    tolerances."""
    from siriltpu_torch.core.frame import Rect
    from siriltpu_torch.ops.stats import STATS_EXTRA, statistics

    r = Reader(os.path.join(GOLDEN_DIR, "c_statistics.bin"))
    ncases = 0
    while not r.eof():
        nx = r.take("H")
        ny = r.take("H")
        nullcheck = r.take("B")
        selflag = r.take("B")
        sx, sy, sw, sh = r.take("hhhh")
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        have = r.take("B")
        sel = Rect(sx, sy, sw, sh) if selflag else None
        got = statistics(img, 0, selection=sel, option=STATS_EXTRA,
                         nullcheck=bool(nullcheck))
        if not have:
            assert got is None
            continue
        total, ngood = r.take("q"), r.take("q")
        (mean, avgdev, mad, median, sigma, bgnoise, vmin, vmax, sqrtbwmv,
         location, scale, normv) = r.take("d" * 12)
        ncases += 1
        assert got is not None, (nx, ny, nullcheck, selflag)
        ctx = str((nx, ny, nullcheck, selflag, ncases))
        assert got.total == total and got.ngoodpix == ngood, ctx
        assert got.median == median and got.mad == mad, ctx
        assert got.min == vmin and got.max == vmax, ctx
        assert got.norm_value == normv, ctx
        np.testing.assert_allclose(got.mean, mean, rtol=1e-13, atol=0, err_msg=ctx)
        np.testing.assert_allclose(got.sigma, sigma, rtol=1e-12, atol=1e-12, err_msg=ctx)
        np.testing.assert_allclose(got.avgdev, avgdev, rtol=1e-12, atol=0, err_msg=ctx)
        np.testing.assert_allclose(got.sqrtbwmv, sqrtbwmv, rtol=1e-10, atol=1e-12,
                                   err_msg=ctx)
        np.testing.assert_allclose(got.bgnoise, bgnoise, rtol=1e-10, atol=1e-12,
                                   err_msg=ctx)
        np.testing.assert_allclose(got.location, location, rtol=1e-10, atol=1e-9,
                                   err_msg=ctx)
        np.testing.assert_allclose(got.scale, scale, rtol=1e-9, atol=1e-9, err_msg=ctx)
    assert ncases >= 40


def test_ser_vs_c(tmp_path):
    """tests/test_c_goldens.py:904 with the port's SER module: the C
    writer's bytes, header parse, full-frame reads (mono, RGB, Bayer with
    VNG), the inverted-endianness quirk, partial reads and the repair of a
    truncated file."""
    import struct

    from siriltpu_torch.core.frame import Frame, Rect
    from siriltpu_torch.io.ser import SER_HEADER_LEN, SerFile

    r = Reader(os.path.join(GOLDEN_DIR, "c_ser.bin"))
    w, h = 40, 30
    npix = w * h

    inputs = [r.take_u16s(npix).reshape(h, w) for _ in range(3)]
    cbytes = r.take_bytes(r.take("q"))
    p = tmp_path / "mono.ser"
    sw = SerFile.create(str(p), width=w, height=h, color_id=0)
    for img in inputs:
        sw.write_frame(Frame(img.reshape(1, h, w).copy()))
    sw.write_and_close()
    assert p.read_bytes() == cbytes, "mono SER bytes differ from C writer"
    hdr = [r.take("i") for _ in range(6)]
    sr = SerFile.open(str(p))
    assert [sr.header.color_id, sr.header.little_endian, sr.header.width,
            sr.header.height, sr.header.bit_pixel_depth, sr.frame_count] == hdr
    for k in range(3):
        np.testing.assert_array_equal(sr.read_frame(k).data[0],
                                      r.take_u16s(npix).reshape(h, w))
    np.testing.assert_array_equal(sr.read_opened_partial(0, 1, Rect(0, 5, 40, 11)),
                                  r.take_u16s(40 * 11).reshape(11, 40))

    inputs = [r.take_u16s(npix * 3).reshape(3, h, w) for _ in range(2)]
    cbytes = r.take_bytes(r.take("q"))
    p = tmp_path / "rgb.ser"
    sw = SerFile.create(str(p), width=w, height=h, color_id=100)
    for img in inputs:
        sw.write_frame(Frame(img.copy()))
    sw.write_and_close()
    assert p.read_bytes() == cbytes, "RGB SER bytes differ from C writer"
    assert r.take("i") == 100
    sr = SerFile.open(str(p))
    for k in range(2):
        np.testing.assert_array_equal(sr.read_frame(k).data,
                                      r.take_u16s(npix * 3).reshape(3, h, w))
    for layer in range(3):
        np.testing.assert_array_equal(
            sr.read_opened_partial(layer, 0, Rect(0, 2, 40, 9)),
            r.take_u16s(40 * 9).reshape(9, 40))

    cfas = [r.take_u16s(npix).reshape(h, w) for _ in range(2)]
    p = tmp_path / "bayer.ser"
    hdr = bytearray(SER_HEADER_LEN)
    hdr[:14] = b"LUCAM-RECORDER"
    struct.pack_into("<iiiiii", hdr, 18, 8, 1, w, h, 16, 2)
    with open(p, "wb") as fo:
        fo.write(hdr)
        for cfa in cfas:
            fo.write(cfa.astype(">u2").tobytes())
    sr = SerFile.open(str(p))
    np.testing.assert_array_equal(
        sr.read_frame(0, debayer=True, bayer_method="vng").data,
        r.take_u16s(npix * 3).reshape(3, h, w))
    for layer in range(3):
        np.testing.assert_array_equal(
            sr.read_opened_partial(layer, 1, Rect(0, 6, 40, 10), debayer=True,
                                   bayer_method="vng"),
            r.take_u16s(40 * 10).reshape(10, 40))
    np.testing.assert_array_equal(sr.read_frame(0).data[0],
                                  r.take_u16s(npix).reshape(h, w))

    with open(p, "r+b") as fo:
        fo.truncate(SER_HEADER_LEN + npix * 2 + npix)
        fo.seek(38)
        fo.write(b"\x00\x00\x00\x00")
    sr = SerFile.open(str(p))
    assert sr.frame_count == r.take("i")
    assert p.read_bytes() == r.take_bytes(r.take("q")), "repaired SER bytes differ"
    assert r.eof()


def test_seqfile_vs_c(tmp_path):
    """tests/test_c_goldens.py:1005 with the port's .seq writer and
    reader: the C writer's text byte for byte, and the fields the
    compiled readseqfile extracts."""
    from siriltpu_torch.core.frame import ImStats, ImgParam, RegData
    from siriltpu_torch.io.seqfile import read_seqfile, write_seqfile
    from siriltpu_torch.io.sequence import Sequence

    r = Reader(os.path.join(GOLDEN_DIR, "c_seqfile.bin"))
    ctext = r.take_bytes(r.take("q"))
    seq = Sequence(seqname="ph_seqtest", beg=1, number=5, selnum=4, fixed=5,
                   reference_image=2, nb_layers=1)
    for i in range(5):
        p = ImgParam(filenum=i + 1, incl=(i != 3))
        if i % 2 == 0:
            p.stats = ImStats(
                mean=1234.5678901 + i, median=1200.0 + i, sigma=56.789 + i,
                avgdev=43.21 + i, mad=40.5 + i, sqrtbwmv=41.25 + i,
                location=0.0183105 + i * 1e-4, scale=0.00087 + i * 1e-5,
                min=12.0, max=65535.0)
        seq.imgparam.append(p)
    seq.regparam[0] = [
        RegData(shiftx=(i - 2) * 3, shifty=2 - i, rot_centre_x=512.25,
                rot_centre_y=384.75, angle=0.125 * i, fwhm=3.5 + 0.25 * i,
                quality=0.912345678 - 0.01 * i)
        for i in range(5)]
    write_seqfile(seq, str(tmp_path))
    mine = (tmp_path / "ph_seqtest.seq").read_bytes().replace(
        b"S 'ph_seqtest'", b"S '/tmp/ph_seqtest'")
    assert mine == ctext, "seqfile text differs from the C writer"

    cseq = tmp_path / "cwritten.seq"
    cseq.write_bytes(ctext)
    got = read_seqfile(str(cseq))
    assert [got.beg, got.number, got.selnum, got.fixed, got.reference_image,
            got.nb_layers] == [r.take("i") for _ in range(6)]
    assert got.imgparam[-1].filenum == r.take("i")
    for i in range(5):
        assert got.imgparam[i].filenum == r.take("i")
        assert int(got.imgparam[i].incl) == r.take("i")
        has = r.take("B")
        assert (got.imgparam[i].stats is not None) == bool(has)
        if has:
            s = got.imgparam[i].stats
            assert (s.mean, s.median, s.sigma, s.location, s.scale) == \
                tuple(r.take("d") for _ in range(5))
    for i in range(5):
        g = got.regparam[0][i]
        assert g.shiftx == r.take("i")
        assert g.shifty == r.take("i")
        assert g.angle == pytest.approx(r.take("d"), abs=1e-7)
        assert g.fwhm == pytest.approx(r.take("d"), abs=1e-6)
        assert g.quality == pytest.approx(r.take("d"), rel=1e-9)
    assert r.eof()
