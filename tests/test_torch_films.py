"""Films of siriltpu_torch against siriltpu's: ``io/avi.py`` (the native and
the Python DIB writers, MJPEG), ``io/mp4.py`` (the MJPEG-in-MP4 muxer),
``io/films.py`` (the RIFF and ISO-BMFF demuxers, the DHT insertion, the
codec backend and its index sidecar, ``film_sequence``),
``io/film_codec.py`` (the libav bridge, where it builds), a film found by
``check_seq`` and a film stacked by ``stack_sequence``.

All of it is host code (NumPy, struct, Pillow, and the same C++ sources
built by each package for itself), so tolerance 0: the same frames and
settings give files equal byte for byte, each package reads the other's
files to equal frames, and the film's stack (image and rejection counters)
equals the JAX package's. Files that a package writes beside a film (the
index sidecar) are made in separate copies, one for each package.
"""

import os
import shutil
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core.frame import Frame as TFrame  # noqa: E402
from siriltpu_torch.io import avi as tavi  # noqa: E402
from siriltpu_torch.io import film_codec as tcodec  # noqa: E402
from siriltpu_torch.io import films as tfilms  # noqa: E402
from siriltpu_torch.io import mp4 as tmp4  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from test_formats_films_display import _pil_jpeg, _strip_dht, _write_mjpeg_avi  # noqa: E402

GOLDEN_MP4 = os.path.join(os.path.dirname(__file__), "goldens", "c_mp4.bin")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    from siriltpu.core import frame
    from siriltpu.io import avi, film_codec, films, mp4, sequence
    return SimpleNamespace(frame=frame, avi=avi, film_codec=film_codec,
                           films=films, mp4=mp4, sequence=sequence)


def frames16(n, c, h, w, seed, lo=0, hi=65535):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, (n, c, h, w)).astype(np.uint16)


def pair_dirs(tmp_path):
    j, t = tmp_path / "jax", tmp_path / "torch"
    j.mkdir()
    t.mkdir()
    return j, t


def write_avi(writer_cls, frame_cls, path, frames, fps, **kw):
    lo, hi = kw.pop("lo", 0), kw.pop("hi", 65535)
    n, c, h, w = frames.shape
    wtr = writer_cls(str(path), w, h, fps=fps, **kw)
    for f in frames:
        wtr.write_frame(frame_cls(f), lo, hi)
    native = wtr.native
    wtr.close()
    return native


def assert_films_equal(ta, ja):
    """The port's FilmFile and the JAX package's on files of the same
    content: the same geometry, rate, backend and frames."""
    assert (ta.width, ta.height, ta.nb_frames, ta._backend) == \
        (ja.width, ja.height, ja.nb_frames, ja._backend)
    assert ta.fps == ja.fps
    for i in range(ta.nb_frames):
        a, b = ta.read_frame(i), ja.read_frame(i)
        assert a.data.dtype == b.data.dtype
        np.testing.assert_array_equal(a.data, b.data)


# --------------------------------------------------------------- DIB AVI

@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shape,lo,hi", [((4, 1, 12, 16), 0, 65535),
                                          ((3, 3, 10, 13), 0, 255),
                                          ((5, 1, 9, 7), 1000, 40000)])
def test_dib_avi_matches_jax(jx, tmp_path, monkeypatch, native, shape, lo, hi):
    """The DIB writer, native or the Python fallback, writes the JAX
    package's bytes (mono or RGB, rows padded to 4 bytes, the display
    cut lo..hi); the native and Python files are equal; each package reads
    either file to the same frames. The native and the Python files are
    equal but for the header's image size where rows need padding."""
    frames = frames16(*shape, seed=sum(shape) + lo, hi=hi + 200)
    if not native:
        monkeypatch.setattr(tavi, "_load_native", lambda: None)
        monkeypatch.setattr(jx.avi, "_load_native", lambda: None)
    jd, td = pair_dirs(tmp_path)
    nt = write_avi(tavi.AviWriter, TFrame, td / "f.avi", frames, 12.5, lo=lo, hi=hi)
    nj = write_avi(jx.avi.AviWriter, jx.frame.Frame, jd / "f.avi", frames, 12.5,
                   lo=lo, hi=hi)
    assert nt == nj == native
    data = (td / "f.avi").read_bytes()
    assert data == (jd / "f.avi").read_bytes()
    for path in (td / "f.avi", jd / "f.avi"):
        assert_films_equal(tfilms.FilmFile.open(str(path)),
                           jx.films.FilmFile.open(str(path)))
    got = tfilms.FilmFile.open(str(td / "f.avi"))
    assert got._backend == "dib"
    # the words are _frame_to_dib's mapping of the planted frames
    for i, f in enumerate(frames):
        dib = np.frombuffer(tavi._frame_to_dib(TFrame(f), lo, hi), np.uint8)
        rows = dib.reshape(shape[2], -1)[:, : 3 * shape[3]].reshape(shape[2], shape[3], 3)
        want = rows[..., ::-1].transpose(2, 0, 1)
        want = want[:1] if (want == want[:1]).all() else want
        np.testing.assert_array_equal(got.read_frame(i).data, want)
    if native:   # the other writer gives the same file, but for one field
        monkeypatch.setattr(tavi, "_load_native", lambda: None)
        assert not write_avi(tavi.AviWriter, TFrame, td / "py.avi", frames, 12.5,
                             lo=lo, hi=hi)
        py = (td / "py.avi").read_bytes()
        assert py[:192] + py[196:] == data[:192] + data[196:]
        # biSizeImage: the native writer counts the rows' padding, the
        # Python one does not, in both packages alike
        h, w = shape[2:]
        assert struct.unpack_from("<I", data, 192)[0] == ((w * 3 + 3) & ~3) * h
        assert struct.unpack_from("<I", py, 192)[0] == w * 3 * h


# ----------------------------------------------------------------- MJPEG

def test_mjpeg_avi_writer_matches_jax(jx, tmp_path):
    """The MJPEG AVI writer (Pillow's encoder) writes the JAX package's
    bytes, which both packages' demuxers read to the same frames."""
    frames = frames16(3, 3, 16, 24, seed=5)
    jd, td = pair_dirs(tmp_path)
    write_avi(tavi.AviWriter, TFrame, td / "m.avi", frames, 17.0, codec="mjpeg",
              jpeg_quality=82)
    write_avi(jx.avi.AviWriter, jx.frame.Frame, jd / "m.avi", frames, 17.0,
              codec="mjpeg", jpeg_quality=82)
    assert (td / "m.avi").read_bytes() == (jd / "m.avi").read_bytes()
    film = tfilms.FilmFile.open(str(td / "m.avi"))
    assert film._backend == "mjpeg"
    assert_films_equal(film, jx.films.FilmFile.open(str(jd / "m.avi")))
    with pytest.raises(ValueError) as want:
        jx.avi.AviWriter(str(jd / "x.avi"), 8, 8, codec="h264")
    with pytest.raises(ValueError, match=str(want.value)):
        tavi.AviWriter(str(td / "x.avi"), 8, 8, codec="h264")


def test_mjpeg_demux_and_dht_match_jax(jx, tmp_path):
    """An MJPEG AVI whose frames alternate with and without Huffman tables
    (the MJPEG convention): the same DHT insertion and the same frames."""
    rng = np.random.default_rng(3)
    raws = [rng.integers(0, 255, (32, 48, 3), dtype=np.uint8) for _ in range(5)]
    jpegs = [j if i % 2 else _strip_dht(j)
             for i, j in enumerate(_pil_jpeg(a) for a in raws)]
    for j in jpegs:
        got = tfilms.ensure_jpeg_dht(j)
        assert got == jx.films.ensure_jpeg_dht(j)
        assert (got is j) == (b"\xff\xc4" in j[:j.find(b"\xff\xda")])
    path = str(tmp_path / "mj.avi")
    _write_mjpeg_avi(path, jpegs, 48, 32, fps=17.0)
    assert_films_equal(tfilms.FilmFile.open(path), jx.films.FilmFile.open(path))
    assert tfilms._STANDARD_DHT == jx.films._STANDARD_DHT


# ------------------------------------------------------------------- MP4

@pytest.mark.parametrize("nlayers", [1, 3])
def test_mp4_muxer_matches_jax(jx, tmp_path, nlayers):
    """The MJPEG-in-MP4 muxer writes the JAX package's bytes, and the
    ISO-BMFF demuxers of both packages read them to the same frames."""
    frames = frames16(4, nlayers, 16, 24, seed=11 + nlayers)
    jd, td = pair_dirs(tmp_path)
    for mod, frame_cls, d in ((tmp4, TFrame, td), (jx.mp4, jx.frame.Frame, jd)):
        avi = tavi if mod is tmp4 else jx.avi
        wtr = mod.Mp4Writer(str(d / "v.mp4"), 24, 16, 30.0)
        for f in frames:
            wtr.add_frame(avi._frame_to_jpeg(frame_cls(f), 91))
        wtr.close()
    assert (td / "v.mp4").read_bytes() == (jd / "v.mp4").read_bytes()
    film = tfilms.FilmFile.open(str(td / "v.mp4"))
    assert film._backend == "mjpeg" and film.nb_frames == 4
    assert_films_equal(film, jx.films.FilmFile.open(str(jd / "v.mp4")))


# ----------------------------------------------------------- libav bridge

def need_codec(jx):
    if not (tcodec.available() and jx.film_codec.available()):
        pytest.skip("libavformat/libavcodec not installed")


@pytest.mark.parametrize("ext,color", [("mp4", True), ("webm", True), ("mp4", False)])
def test_film_codec_matches_jax(jx, tmp_path, ext, color):
    """H.264 MP4 and VP9 WEBM through the libav bridge: the port's encoder
    writes what the JAX package's writes from the same frames (the MP4 byte
    for byte; the WebM but for its random segment UID); each
    package's decoder reads the other's film to the same frames; and a
    film opened by the codec backend writes the same index sidecar, which
    each package reads back."""
    need_codec(jx)
    rng = np.random.default_rng(1)
    h, w = 32, 48
    yy, xx = np.mgrid[0:h, 0:w]
    frames = [np.clip(200 * np.exp(-((xx - 8 - 4 * i) ** 2 + (yy - 16) ** 2) / 90.0)
                      + rng.integers(0, 4, (h, w)) + 16, 0, 255).astype(np.uint8)
              for i in range(6)]
    if color:
        frames = [np.stack([f, f // 2, f // 3], -1) for f in frames]
    jd, td = pair_dirs(tmp_path)
    for mod, d in ((tcodec, td), (jx.film_codec, jd)):
        enc = mod.FilmEncoder(str(d / f"f.{ext}"), w, h, 24.0, 3 if color else 1,
                              quality=4)
        for f in frames:
            enc.add_frame(np.ascontiguousarray(f))
        enc.close()
    if ext == "mp4":
        assert (td / f"f.{ext}").read_bytes() == (jd / f"f.{ext}").read_bytes()
    else:   # the WebM muxer writes a random segment UID into each file
        assert (td / f"f.{ext}").stat().st_size == (jd / f"f.{ext}").stat().st_size
    dt, dj = tcodec.FilmDecoder(str(td / f"f.{ext}")), jx.film_codec.FilmDecoder(
        str(jd / f"f.{ext}"))
    assert (dt.width, dt.height, dt.nb_frames, dt.fps) == \
        (dj.width, dj.height, dj.nb_frames, dj.fps)
    for i in (0, 3, 5, 1):           # random access: seeks back and forth
        np.testing.assert_array_equal(dt.read(i), dj.read(i))
    dt.close()
    dj.close()
    ft = tfilms.FilmFile.open(str(td / f"f.{ext}"))
    fj = jx.films.FilmFile.open(str(jd / f"f.{ext}"))
    assert ft._backend == "codec"
    assert (td / f"f.{ext}.idx.json").read_text() == \
        (jd / f"f.{ext}.idx.json").read_text().replace(str(jd), str(td))
    assert_films_equal(ft, fj)
    # a second open is a sidecar hit: the decoder opens at the first read
    again = tfilms.FilmFile.open(str(td / f"f.{ext}"))
    assert again._codec is None
    assert_films_equal(again, fj)


@pytest.mark.parametrize("which", ["mp4", "webm"])
def test_reference_export_decodes_as_jax(jx, tmp_path, which):
    """The compiled reference's own H.264 and VP9 exports
    (``c_mp4.bin``): the port's decoder gives the JAX package's frames,
    and the JAX test's checks of geometry, rate and content hold."""
    need_codec(jx)
    from test_mp4_goldens import _expected_rgb8, _load
    nf, nl, h, w, fps, quality, frames, mp4, webm = _load()
    p = tmp_path / f"ref.{which}"
    p.write_bytes(mp4 if which == "mp4" else webm)
    dt, dj = tcodec.FilmDecoder(str(p)), jx.film_codec.FilmDecoder(str(p))
    assert (dt.width, dt.height, dt.nb_frames, dt.fps) == \
        (dj.width, dj.height, dj.nb_frames, dj.fps) and (dt.width, dt.height) == (w, h)
    assert fps <= dt.fps <= fps * nf / (nf - 1) + 0.01
    for i in range(dt.nb_frames):
        got = dt.read(i)
        np.testing.assert_array_equal(got, dj.read(i))
        want = _expected_rgb8(frames[i]).astype(np.float64)
        assert np.abs(got.astype(np.float64) - want).mean() < 48.0
    dt.close()
    dj.close()


# ---------------------------------------------------------- refusals

@pytest.mark.parametrize("name,payload", [
    ("garbage.avi", b"RIFF\x10\x00\x00\x00AVI LIST\xff\xff\xff\xff"),
    ("short.avi", b"RI"),
    ("garbage.mp4", b"\x00\x00\x00\x08ftypisom" + b"\x00" * 4),
    ("truncmoov.mp4", b"\x00\x00\x00\x10ftypisom\x00\x00\x02\x00"
     + b"\x00\x00\xff\xffmoov" + b"\x12" * 16),
    ("noise.mp4", bytes(range(256)) * 8),
    ("h264.avi", None),
])
def test_malformed_films_match_jax(jx, tmp_path, name, payload):
    """Truncated or foreign containers fail alike in both packages: the
    same exception type and message."""
    jd, td = pair_dirs(tmp_path)
    for d in (jd, td):
        if payload is None:   # an AVI whose codec no demuxer here reads
            _write_mjpeg_avi(str(d / name), [b"\x00" * 10], 8, 8)
            (d / name).write_bytes((d / name).read_bytes().replace(b"MJPG", b"H264"))
        else:
            (d / name).write_bytes(payload)
    with pytest.raises(Exception) as want:
        jx.films.FilmFile.open(str(jd / name))
    with pytest.raises(want.type) as got:
        tfilms.FilmFile.open(str(td / name))
    assert str(got.value) == str(want.value).replace(str(jd), str(td))


# ------------------------------------------------ check_seq and the stack

def test_check_seq_finds_films_as_jax(jx, tmp_path):
    """A directory holding a DIB AVI, an MJPEG MP4 and a film no backend
    reads: both packages find the same two film sequences (name, type,
    frames, geometry) and skip the third; their frames are equal."""
    frames = frames16(3, 1, 10, 14, seed=2, hi=255)
    jd, td = pair_dirs(tmp_path)
    for avi, mp4, frame_cls, d in ((tavi, tmp4, TFrame, td),
                                   (jx.avi, jx.mp4, jx.frame.Frame, jd)):
        write_avi(avi.AviWriter, frame_cls, d / "night.avi", frames, 25.0, hi=255)
        wtr = mp4.Mp4Writer(str(d / "clip.mp4"), 14, 10, 25.0)
        for f in frames:
            wtr.add_frame(avi._frame_to_jpeg(frame_cls(f), 90, 0, 255))
        wtr.close()
        (d / "broken.mkv").write_bytes(b"\x1a\x45\xdf\xa3" + b"\0" * 12)
    got, want = tsequence.check_seq(str(td)), jx.sequence.check_seq(str(jd))
    assert [(s.seqname, s.seqtype, s.number, s.selnum, s.rx, s.ry) for s in got] == \
        [(s.seqname, s.seqtype, s.number, s.selnum, s.rx, s.ry) for s in want]
    assert sorted(s.seqname for s in got) == ["clip", "night"]
    for g, w in zip(got, want):
        for i in range(g.number):
            np.testing.assert_array_equal(g.read_frame(i).data, w.read_frame(i).data)
        np.testing.assert_array_equal(
            g.read_frame_part(1, 0, tsequence.Rect(2, 3, 8, 5)),
            w.read_frame_part(1, 0, jx.frame.Rect(2, 3, 8, 5)))
        assert g.nb_layers == w.nb_layers == 1


def test_film_stack_sequence_matches_jax(jx, tmp_path):
    """A DIB AVI of a drifting disc, opened by ``film_sequence`` with its
    shifts set, stacked by ``stack_sequence(mean, winsorized (3, 3),
    additive_scaling)``: the port's stack on the CPU (the plain version of
    the kernel) equals the JAX package's, image and counters."""
    from siriltpu.stacking import api as japi
    n, h, w = 8, 24, 32
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:h, 0:w]
    shifts = rng.integers(-3, 4, (n, 2))
    frames = np.stack([np.clip(
        180 * np.exp(-((xx - 16 - s[0]) ** 2 + (yy - 12 - s[1]) ** 2) / 40.0)
        + 20 + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint16)[None]
        for s in shifts])
    frames[2, 0, 5, 5] = 255          # an outlier the clip removes
    jd, td = pair_dirs(tmp_path)
    write_avi(tavi.AviWriter, TFrame, td / "disc.avi", frames, 30.0, hi=255)
    shutil.copy(td / "disc.avi", jd / "disc.avi")
    tseq = tfilms.film_sequence(str(td / "disc.avi"))
    jseq = jx.films.film_sequence(str(jd / "disc.avi"))
    for seq in (tseq, jseq):
        reg = seq.ensure_regparam(0)
        for r, (sx, sy) in zip(reg, -shifts):
            r.shiftx, r.shifty = int(sx), int(sy)
    kw = dict(method="mean", rejection="winsorized", sig=(3.0, 3.0),
              normalize="additive_scaling")
    got = tapi.stack_sequence(tseq, device="cpu", stream=False, **kw)
    want = japi.stack_sequence(jseq, stream=False, **kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.rejection_low, want.rejection_low)
    np.testing.assert_array_equal(got.rejection_high, want.rejection_high)
    assert got.total_pixels == want.total_pixels
