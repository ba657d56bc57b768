"""Sequence export of siriltpu_torch against siriltpu's: ``io/export.py``
(``ExportArgs``, ``export_sequence``) to SER, DIB AVI, MJPEG AVI, MP4 (the
MJPEG-in-MP4 muxer, and H.264 through the libav bridge where it builds),
WEBM and FITS, with the registration shifts, the additive normalization,
a crop and a resize.

The same seeded frames, shifts and arguments go to both packages, each in
its own directory. Tolerance 0: the files are equal byte for byte (FITS
but its ``DATE`` card; the WebM but its random segment UID, so there the
decoded frames are compared) and the exported frames equal
``shift_gather`` of the planted ones. One exception, stated where it
applies: a resize is a float32 matmul on the device
(``ops/imops.py:resize``), held within 1 LSB of the JAX package's on 0.5%
of the words, as tests/test_torch_calibration.py holds ``resize``; the
port's export equals its own ``resize`` composed by hand.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core.frame import Frame as TFrame, Rect as TRect  # noqa: E402
from siriltpu_torch.io import export as texport  # noqa: E402
from siriltpu_torch.io import film_codec as tcodec  # noqa: E402
from siriltpu_torch.io import films as tfilms  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.io.ser import SerFile as TSerFile  # noqa: E402
from siriltpu_torch.ops import imops as timops  # noqa: E402
from siriltpu_torch.verify.oracle import shift_gather  # noqa: E402

N, H, W = 4, 24, 34


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    from siriltpu.core import frame
    from siriltpu.io import export, film_codec, films, fits, sequence, ser
    return SimpleNamespace(frame=frame, export=export, film_codec=film_codec,
                           films=films, fits=fits, sequence=sequence, ser=ser)


def fits_bytes(path) -> bytes:
    """A FITS file's bytes with the value of its DATE card blanked."""
    raw = bytearray(open(path, "rb").read())
    for off in range(0, len(raw), 80):
        if raw[off:off + 8] == b"DATE    ":
            raw[off + 10:off + 30] = b" " * 20
            break
    return bytes(raw)


def make_frames(c, seed=3):
    rng = np.random.default_rng(seed)
    sky = rng.normal(3000, 200, (c, H, W))
    sky[:, rng.integers(0, H, 6), rng.integers(0, W, 6)] += 30000
    return np.stack([np.clip(sky * (1 + 0.03 * i) + 50 * i + rng.normal(0, 20, (c, H, W)),
                             0, 65535).astype(np.uint16) for i in range(N)])


SHIFTS = np.array([[0, 0], [2, -1], [-3, 2], [1, 3]])


def sequences(jx, tmp_path, c):
    """The same FITS sequence in two directories, opened by each package's
    ``check_seq``, with the same shifts and one frame left out."""
    frames = make_frames(c, seed=c)
    seqs = []
    for side, fits_mod, frame_cls, seqmod in (
            ("jax", jx.fits, jx.frame.Frame, jx.sequence),
            ("torch", tfits, TFrame, tsequence)):
        d = tmp_path / side
        d.mkdir()
        for i, f in enumerate(frames):
            fits_mod.write_fits(str(d / f"e{i + 1:03d}.fit"), frame_cls(f))
        seq = seqmod.check_seq(str(d))[0]
        for r, (sx, sy) in zip(seq.ensure_regparam(0), SHIFTS):
            r.shiftx, r.shifty = int(sx), int(sy)
        seq.set_included(2, False)
        seqs.append(seq)
    return frames, seqs[0], seqs[1]


OPTIONS = {
    "plain": {},
    "norm": dict(normalize=True),
    "crop": dict(crop=(3, 4, 20, 14)),
    "norm_crop": dict(normalize=True, crop=(0, 2, 33, 21)),
}


def export_both(jx, jseq, tseq, fmt, opts, **kw):
    crop = opts.get("crop")
    common = dict(basename="out", fmt=fmt, fps=12.0, quality=4,
                  normalize=opts.get("normalize", False))
    common.update(kw)
    pj = jx.export.export_sequence(jseq, jx.export.ExportArgs(
        crop=jx.frame.Rect(*crop) if crop else None, **common))
    pt = texport.export_sequence(tseq, texport.ExportArgs(
        crop=TRect(*crop) if crop else None, **common), device="cpu")
    assert os.path.basename(pt) == os.path.basename(pj)
    return pj, pt


def expected_words(jx, frames, opts, jseq):
    """``shift_gather`` of the planted included frames, normalized and
    cropped as the export does, by hand."""
    from siriltpu.stacking.api import sequence_normalization
    from siriltpu_torch.utils.rounding import np_round_to_word
    idx = [0, 1, 3]
    out = [shift_gather(frames[i], *SHIFTS[i], fill=0, skip_origin=False) for i in idx]
    if opts.get("normalize"):
        off, _, scale = sequence_normalization(jseq, 0, idx, "additive_scaling")
        out = [np_round_to_word(o.astype(np.float64) * scale[k] - off[k])
               for k, o in enumerate(out)]
    if opts.get("crop"):
        out = [timops.crop(o, *opts["crop"]) for o in out]
    return out


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("opt", sorted(OPTIONS))
@pytest.mark.parametrize("fmt", ["ser", "fits", "avi", "mjpeg"])
def test_export_matches_jax(jx, tmp_path, fmt, opt, c):
    """SER, FITS, DIB AVI and MJPEG AVI, each plain, normalized, cropped
    and both: the same files from both packages; the SER and FITS words are
    the shifted, normalized, cropped frames by hand."""
    frames, jseq, tseq = sequences(jx, tmp_path, c)
    opts = OPTIONS[opt]
    pj, pt = export_both(jx, jseq, tseq, fmt, opts)
    if fmt == "fits":
        names = sorted(n for n in os.listdir(tmp_path / "jax") if n.startswith("out"))
        assert names == sorted(n for n in os.listdir(tmp_path / "torch")
                               if n.startswith("out")) == [
            f"out{k:05d}.fit" for k in (1, 2, 3)]
        got = [tfits.read_fits(str(tmp_path / "torch" / n)).data for n in names]
        for n in names:
            assert fits_bytes(tmp_path / "torch" / n) == fits_bytes(tmp_path / "jax" / n)
    else:
        assert open(pt, "rb").read() == open(pj, "rb").read()
        if fmt == "ser":
            ser = TSerFile.open(pt)
            got = [ser.read_frame(k).data for k in range(ser.frame_count)]
        else:
            film = tfilms.FilmFile.open(pt)
            assert film._backend == ("dib" if fmt == "avi" else "mjpeg")
            assert film.nb_frames == 3
            return
    want = expected_words(jx, frames, opts, jseq)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("c", [1, 3])
def test_export_mp4_muxer_matches_jax(jx, tmp_path, monkeypatch, c):
    """MP4 without the libav bridge: the MJPEG-in-MP4 muxer's files are
    equal, and both demuxers read them to the same frames."""
    monkeypatch.setattr(tcodec, "available", lambda: False)
    monkeypatch.setattr(jx.film_codec, "available", lambda: False)
    frames, jseq, tseq = sequences(jx, tmp_path, c)
    pj, pt = export_both(jx, jseq, tseq, "mp4", OPTIONS["norm_crop"])
    assert open(pt, "rb").read() == open(pj, "rb").read()
    ft, fj = tfilms.FilmFile.open(pt), jx.films.FilmFile.open(pj)
    assert (ft._backend, ft.nb_frames, ft.width, ft.height) == ("mjpeg", 3, 33, 21)
    for i in range(3):
        np.testing.assert_array_equal(ft.read_frame(i).data, fj.read_frame(i).data)


def test_export_webm_without_codec_matches_jax(jx, tmp_path, monkeypatch):
    """WEBM without the libav bridge goes to imageio's ffmpeg plugin: both
    packages write it where the plugin is there, or raise the same
    RuntimeError where it is not."""
    monkeypatch.setattr(tcodec, "available", lambda: False)
    monkeypatch.setattr(jx.film_codec, "available", lambda: False)
    frames, jseq, tseq = sequences(jx, tmp_path, 1)
    try:
        pj = jx.export.export_sequence(jseq, jx.export.ExportArgs(basename="w", fmt="webm"))
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            texport.export_sequence(tseq, texport.ExportArgs(basename="w", fmt="webm"),
                                    device="cpu")
        assert str(got.value).split("(")[0] == str(e).split("(")[0]
        return
    pt = texport.export_sequence(tseq, texport.ExportArgs(basename="w", fmt="webm"),
                                 device="cpu")
    assert os.path.getsize(pt) == os.path.getsize(pj)


@pytest.mark.parametrize("fmt", ["mp4", "webm"])
def test_export_codec_matches_jax(jx, tmp_path, fmt):
    """H.264 MP4 and VP9 WEBM through the libav bridge (the resize inside
    the encoder, as the reference's): the MP4 files are equal, the WebM
    files decode to the same frames in both packages. Quality 5: at a tiny
    frame the reference's bit rate formula gives x264 no rate below it."""
    if not (tcodec.available() and jx.film_codec.available()):
        pytest.skip("libavformat/libavcodec not installed")
    frames, jseq, tseq = sequences(jx, tmp_path, 3)
    pj, pt = export_both(jx, jseq, tseq, fmt, {"crop": (2, 2, 30, 20)}, resize=(32, 24),
                         quality=5)
    if fmt == "mp4":
        assert open(pt, "rb").read() == open(pj, "rb").read()
    dt, dj = tcodec.FilmDecoder(pt), jx.film_codec.FilmDecoder(pj)
    assert (dt.width, dt.height, dt.nb_frames) == (dj.width, dj.height, dj.nb_frames) \
        == (32, 24, 3)
    for i in range(3):
        np.testing.assert_array_equal(dt.read(i), dj.read(i))
    dt.close()
    dj.close()


@pytest.mark.parametrize("fmt", ["fits", "ser"])
def test_export_resize_matches_jax(jx, tmp_path, fmt):
    """A resize (INTER_AREA, the reference's value 3) after the crop: the
    port's words equal its own ``resize`` of the cropped frames by hand,
    and the JAX package's within 1 LSB on 0.5% of the words (the float32
    matmul summed in another order, tests/test_torch_calibration.py)."""
    frames, jseq, tseq = sequences(jx, tmp_path, 1)
    opts = OPTIONS["crop"]
    pj, pt = export_both(jx, jseq, tseq, fmt, opts, resize=(13, 9))
    if fmt == "fits":
        read = lambda d: [tfits.read_fits(str(tmp_path / d / f"out{k:05d}.fit")).data
                          for k in (1, 2, 3)]
        got, want = read("torch"), read("jax")
    else:
        st, sj = TSerFile.open(pt), jx.ser.SerFile.open(pj)
        got = [st.read_frame(k).data for k in range(3)]
        want = [sj.read_frame(k).data for k in range(3)]
    by_hand = [timops.resize(f, 13, 9, interpolation=3, device="cpu")
               for f in expected_words(jx, frames, opts, jseq)]
    for g, w, b in zip(got, want, by_hand):
        assert g.shape == (1, 9, 13)
        np.testing.assert_array_equal(g, b)
        d = np.abs(g.astype(int) - w.astype(int))
        assert d.max() <= 1 and (d != 0).mean() <= 0.005


def test_export_refuses_as_jax(jx, tmp_path):
    frames, jseq, tseq = sequences(jx, tmp_path, 1)
    with pytest.raises(ValueError) as want:
        jx.export.export_sequence(jseq, jx.export.ExportArgs(fmt="gif"))
    with pytest.raises(ValueError, match=str(want.value)):
        texport.export_sequence(tseq, texport.ExportArgs(fmt="gif"), device="cpu")
