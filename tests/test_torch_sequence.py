"""siriltpu_torch.io.sequence, io.seqfile, core.memory and the sequence
half of stacking.api (filter_indices, sequence_normalization) against
siriltpu's, and a sequence's state carried across in memory
(utils.interop.sequence_to_fields / sequence_from_fields).

The same seeded frames are written once to disk, as numbered FITS files
or as a SER file, and opened by both packages. Tolerance 0: the ``.seq``
text is equal byte for byte, and the normalization coefficients and the
cached statistics are equal exactly.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu.core import frame as jframe  # noqa: E402
from siriltpu.core import memory as jmemory  # noqa: E402
from siriltpu.io import fits as jfits  # noqa: E402
from siriltpu.io import seqfile as jseqfile  # noqa: E402
from siriltpu.io import sequence as jsequence  # noqa: E402
from siriltpu.io import ser as jser  # noqa: E402
from siriltpu.stacking import api as japi  # noqa: E402
from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.core import memory as tmemory  # noqa: E402
from siriltpu_torch.io import seqfile as tseqfile  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

F, H, W = 9, 64, 80


def make_frames(c: int = 1, seed: int = 0) -> np.ndarray:
    """(F, C, H, W) uint16 sky near 1000 with a level and a gain a frame
    and a few bright sources."""
    rng = np.random.default_rng(seed)
    sky = rng.normal(1000, 30, (c, H, W))
    sky[:, rng.integers(0, H, 12), rng.integers(0, W, 12)] += 20000
    out = [np.clip(sky * (1 + 0.05 * i) + 20 * i + rng.normal(0, 10, (c, H, W)),
                   0, 65535).astype(np.uint16) for i in range(F)]
    return np.stack(out)


def write_fits_dir(directory, frames, base="light_", first=3):
    for i, fr in enumerate(frames):
        jfits.write_fits(os.path.join(directory, f"{base}{first + i:05d}.fit"),
                         jframe.Frame(fr))


def write_ser(path, frames):
    c = frames.shape[1]
    s = jser.SerFile.create(path, W, H,
                            color_id=jser.SER_RGB if c == 3 else jser.SER_MONO)
    for fr in frames:
        s.write_frame(jframe.Frame(fr))
    s.write_and_close()


def set_state(seq, seed=5):
    """Registration data on layer 0, two excluded frames and a reference
    image, the same for either package's sequence."""
    rng = np.random.default_rng(seed)
    reg = seq.ensure_regparam(0)
    for r, q, fw, sh in zip(reg, rng.random(F), rng.uniform(2, 5, F),
                            rng.integers(-3, 4, (F, 2))):
        r.shiftx, r.shifty = int(sh[0]), int(sh[1])
        r.quality, r.fwhm = float(q), float(fw)
        r.rot_centre_x, r.angle = 1.25, 0.5
    seq.set_included(2, False)
    seq.set_included(6, False)
    seq.reference_image = 1


def as_dict(stats):
    return None if stats is None else dataclasses.asdict(stats)


def assert_same_state(got, want):
    for key in ("seqname", "seqtype", "beg", "number", "selnum", "fixed",
                "reference_image", "nb_layers"):
        assert getattr(got, key) == getattr(want, key), key
    assert [vars(p) | {"stats": as_dict(p.stats)} for p in got.imgparam] == [
        vars(p) | {"stats": as_dict(p.stats)} for p in want.imgparam]
    assert got.regparam.keys() == want.regparam.keys()
    for layer in want.regparam:
        assert ([vars(r) for r in got.regparam[layer]]
                == [vars(r) for r in want.regparam[layer]])


# ------------------------------------------------------------ discovery, .seq

def test_check_seq_discovers_what_jax_discovers(tmp_path):
    frames = make_frames()
    dirs = []
    for name in ("j", "t"):
        d = tmp_path / name
        d.mkdir()
        write_fits_dir(str(d), frames)
        write_fits_dir(str(d), frames[:3], base="dark", first=1)
        jfits.write_fits(str(d / "single_001.fit"), jframe.Frame(frames[0]))
        write_ser(str(d / "capture.ser"), frames)
        (d / "notes.txt").write_text("x")
        dirs.append(str(d))
    want = jsequence.check_seq(dirs[0])
    got = tsequence.check_seq(dirs[1])
    assert [(s.seqname, s.seqtype, s.number, s.beg, s.end, s.fixed, s.ext)
            for s in got] == [(s.seqname, s.seqtype, s.number, s.beg, s.end,
                               s.fixed, s.ext) for s in want]
    assert sorted(s.seqname for s in got) == ["capture", "dark", "light_"]
    for name in ("light_.seq", "dark.seq"):
        assert (open(os.path.join(dirs[0], name)).read()
                == open(os.path.join(dirs[1], name)).read())
    # the frames read the same through either sequence
    for g, w in zip(got, want):
        for i in (0, g.number - 1):
            np.testing.assert_array_equal(g.read_frame(i).data, w.read_frame(i).data)
            np.testing.assert_array_equal(
                g.read_frame_part(i, 0, tframe.Rect(0, 5, W, 20)),
                w.read_frame_part(i, 0, jframe.Rect(0, 5, W, 20)))
        assert (g.nb_layers, g.rx, g.ry) == (w.nb_layers, w.rx, w.ry) == (1, W, H)
    # a second scan reads the .seq files back; force rebuilds them
    again = tsequence.check_seq(dirs[1])
    assert [s.seqname for s in again] == [s.seqname for s in got]
    assert [s.seqname for s in tsequence.check_seq(dirs[1], force=True)] == [
        s.seqname for s in got]
    assert tsequence.get_index_and_basename("light_00012.fit") == \
        jsequence.get_index_and_basename("light_00012.fit") == ("light_", 12, 5, "fit")
    assert tsequence.get_index_and_basename("nonumber.fit") is None


def test_check_seq_film_names_its_roadmap_item(tmp_path):
    (tmp_path / "movie.avi").write_bytes(b"RIFF")
    with pytest.raises(NotImplementedError, match="io/films.py"):
        tsequence.check_seq(str(tmp_path))
    assert tsequence.FILM_EXTENSIONS == jsequence._film_exts()


@pytest.mark.parametrize("kind", ["regular", "ser"])
def test_seqfile_text_byte_equal_and_round_trip(tmp_path, kind):
    frames = make_frames()
    d = str(tmp_path)
    if kind == "ser":
        write_ser(os.path.join(d, "cap.ser"), frames)
        jseq = jsequence.ser_sequence(os.path.join(d, "cap.ser"))
        tseq = tsequence.ser_sequence(os.path.join(d, "cap.ser"))
    else:
        write_fits_dir(d, frames)
        jseq = jsequence.check_seq(d)[0]
        tseq = tsequence.check_seq(d)[0]
    set_state(jseq)
    set_state(tseq)
    # cached statistics on some frames only
    for i in (0, 4):
        jseq.get_imstats(i, 0, compute=lambda fr: japi.statistics(
            fr, 0, option=japi.STATS_EXTRA))
        tseq.get_imstats(i, 0, compute=lambda fr: tapi.statistics(
            fr, 0, option=tapi.STATS_EXTRA))
    assert jseq.needs_saving and tseq.needs_saving
    jdir, tdir = tmp_path / "jout", tmp_path / "tout"
    jdir.mkdir()
    tdir.mkdir()
    jpath = jseqfile.write_seqfile(jseq, str(jdir))
    tpath = tseqfile.write_seqfile(tseq, str(tdir))
    text = open(tpath).read()
    assert text == open(jpath).read()
    assert ("TS\n" in text) == (kind == "ser")
    assert not tseq.needs_saving
    # each package reads the other's file to the same state, and writing
    # that state again gives the same text
    jback, tback = jseqfile.read_seqfile(tpath), tseqfile.read_seqfile(jpath)
    assert_same_state(tback, jback)
    assert tback.selnum == F - 2 and tback.reference_image == 1
    np.testing.assert_array_equal(tback.reg_shifts(0), tseq.reg_shifts(0))
    assert tback.included_indices() == tseq.included_indices()
    assert tback.imgparam[4].stats.location == float(
        f"{tseq.imgparam[4].stats.location:g}")
    again = tmp_path / "again"
    again.mkdir()
    assert open(tseqfile.write_seqfile(tback, str(again))).read() == text


def test_read_seqfile_refuses_what_jax_refuses(tmp_path):
    bad = {"empty.seq": "#nothing\n",
           "short.seq": "S 'x' 0 3 3 5 -1\nL 1\nI 0 1\n",
           "long.seq": "S 'x' 0 1 1 5 -1\nL 1\nI 0 1\nI 1 1\n"}
    for name, text in bad.items():
        (tmp_path / name).write_text(text)
        for mod in (jseqfile, tseqfile):
            with pytest.raises(ValueError):
                mod.read_seqfile(str(tmp_path / name))
    # a wrong selection count is fixed in memory
    (tmp_path / "sel.seq").write_text("S 'x' 0 2 2 5 -1\nL 1\nI 0 1\nI 1 0\n")
    assert tseqfile.read_seqfile(str(tmp_path / "sel")).selnum == \
        jseqfile.read_seqfile(str(tmp_path / "sel")).selnum == 1


def test_internal_sequence_matches_jax():
    frames = make_frames(3)
    jseq = jsequence.internal_sequence([jframe.Frame(fr) for fr in frames])
    tseq = tsequence.internal_sequence([tframe.Frame(fr) for fr in frames])
    assert_same_state(tseq, jseq)
    assert (tseq.nb_layers, tseq.rx, tseq.ry) == (3, W, H)
    np.testing.assert_array_equal(
        tseq.read_frame_part(2, 1, tframe.Rect(4, 6, 20, 10)),
        jseq.read_frame_part(2, 1, jframe.Rect(4, 6, 20, 10)))
    assert tseq.image_filename(3) == jseq.image_filename(3)


# ------------------------------------------------------- state carried across

@pytest.mark.parametrize("kind", ["ser", "internal"])
def test_sequence_state_crosses_as_plain_fields(tmp_path, kind):
    """A siriltpu Sequence's fields, as a dict of scalars and arrays, make
    the port's Sequence with the same state, which reads the same frames
    and stacks to the same image."""
    frames = make_frames()
    if kind == "ser":
        write_ser(str(tmp_path / "cap.ser"), frames)
        jseq = jsequence.ser_sequence(str(tmp_path / "cap.ser"))
    else:
        jseq = jsequence.internal_sequence([jframe.Frame(fr) for fr in frames])
    set_state(jseq)
    japi.sequence_normalization(jseq, 0, [0, 3, 4], "additive")
    fields = interop.sequence_to_fields(jseq)
    assert fields["stats"].shape == (F, len(interop.STATS_COLUMNS))
    assert np.isnan(fields["stats"][1]).all() and not np.isnan(fields["stats"][3]).any()
    assert fields["reg"][0].shape == (F, len(interop.REG_COLUMNS))
    tseq = interop.sequence_from_fields(
        fields, frames=frames if kind == "internal" else None)
    assert isinstance(tseq, tsequence.Sequence)
    assert_same_state(tseq, jseq)
    # and back: the port's sequence gives the same fields
    back = interop.sequence_to_fields(tseq)
    for key, val in fields.items():
        if key == "reg":
            assert all(np.array_equal(back[key][k], v) for k, v in val.items())
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(back[key], val)
        else:
            assert back[key] == val, key
    for i in (0, F - 1):
        np.testing.assert_array_equal(tseq.read_frame(i).data, jseq.read_frame(i).data)
    kw = dict(method="mean", rejection="sigma", normalize="additive_scaling")
    want = japi.stack_sequence(jseq, **kw)
    got = tapi.stack_sequence(tseq, device="cpu", **kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.rejection_low, want.rejection_low)


# ---------------------------------------------------------------- filtering

def _filter_seqs(tmp_path):
    write_ser(str(tmp_path / "cap.ser"), make_frames())
    jseq = jsequence.ser_sequence(str(tmp_path / "cap.ser"))
    tseq = tsequence.ser_sequence(str(tmp_path / "cap.ser"))
    set_state(jseq)
    set_state(tseq)
    return jseq, tseq


@pytest.mark.parametrize("filter_type,param", [
    ("all", 0.0), ("included", 0.0), ("best_fwhm", 0.0), ("best_fwhm", 40.0),
    ("best_fwhm", 100.0), ("best_quality", 0.0), ("best_quality", 35.0),
    ("best_quality", 100.0)])
def test_filter_indices_matches_jax(tmp_path, filter_type, param):
    jseq, tseq = _filter_seqs(tmp_path)
    want = japi.filter_indices(jseq, filter_type=filter_type, param=param)
    got = tapi.filter_indices(tseq, filter_type=filter_type, param=param)
    assert got == want
    if filter_type == "all":
        assert got == list(range(F))
    else:
        assert 2 not in got and 6 not in got
    if param in (40.0, 35.0):
        assert 0 < len(got) < F - 2


@pytest.mark.parametrize("filter_type,field,value,frame", [
    # any frame, even an excluded one, with fwhm <= 0 aborts best_fwhm
    ("best_fwhm", "fwhm", 0.0, 2),
    # an included frame with quality < 0 aborts best_quality...
    ("best_quality", "quality", -1.0, 3),
    # ...an excluded one does not
    ("best_quality", "quality", -1.0, 6)])
def test_filter_indices_abort_quirks_match_jax(tmp_path, filter_type, field,
                                               value, frame):
    jseq, tseq = _filter_seqs(tmp_path)
    for seq in (jseq, tseq):
        setattr(seq.regparam[0][frame], field, value)
    want = japi.filter_indices(jseq, filter_type=filter_type, param=50.0)
    got = tapi.filter_indices(tseq, filter_type=filter_type, param=50.0)
    assert got == want
    assert (got == []) == (frame != 6)


def test_filter_indices_errors(tmp_path):
    _, tseq = _filter_seqs(tmp_path)
    with pytest.raises(ValueError, match="unknown filter"):
        tapi.filter_indices(tseq, filter_type="bogus")
    with pytest.raises(ValueError, match="registration data required"):
        tapi.filter_indices(tseq, filter_type="best_fwhm", layer=1)


# ------------------------------------------------------------ normalization

@pytest.mark.parametrize("kind,c", [("ser", 1), ("ser", 3), ("regular", 1)])
@pytest.mark.parametrize("mode", ["additive", "additive_scaling",
                                  "multiplicative", "multiplicative_scaling"])
def test_sequence_normalization_matches_jax_exactly(tmp_path, kind, c, mode):
    frames = make_frames(c, seed=3)
    d = str(tmp_path)
    if kind == "ser":
        write_ser(os.path.join(d, "cap.ser"), frames)
        jseq = jsequence.ser_sequence(os.path.join(d, "cap.ser"))
        tseq = tsequence.ser_sequence(os.path.join(d, "cap.ser"))
    else:
        write_fits_dir(d, frames)
        jseq = jsequence.check_seq(d)[0]
        shutil.rmtree(d)
        os.mkdir(d)
        write_fits_dir(d, frames)
        tseq = tsequence.check_seq(d)[0]
    jseq.reference_image = tseq.reference_image = 4
    indices = [1, 2, 4, 5, 7, 8]
    layer = c - 1
    want = japi.sequence_normalization(jseq, layer, indices, mode)
    got = tapi.sequence_normalization(tseq, layer, indices, mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    # the reference frame's coefficients are the identity
    assert (got[0][2], got[1][2], got[2][2]) == (0.0, 1.0, 1.0)
    assert len({round(v, 9) for v in got[2 if mode.endswith("scaling") else
                                         (0 if mode == "additive" else 1)]}) > 3
    # the cache holds the same statistics, on the frames asked for only
    assert tseq.needs_saving
    for i in range(F):
        assert as_dict(tseq.imgparam[i].stats) == as_dict(jseq.imgparam[i].stats)
        assert (tseq.imgparam[i].stats is not None) == (i in indices)
    # a second call reads the cache: no frame is read again
    tseq.read_frame = None
    again = tapi.sequence_normalization(tseq, layer, indices, mode)
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g, w)


def test_sequence_normalization_none_and_reference_outside(tmp_path):
    jseq, tseq = _filter_seqs(tmp_path)
    for g, w in zip(tapi.sequence_normalization(tseq, 0, [0, 1, 2], "none"),
                    japi.sequence_normalization(jseq, 0, [0, 1, 2], "none")):
        np.testing.assert_array_equal(g, w)
    assert tseq.imgparam[0].stats is None
    # the reference image (1) is not among the frames: the first one leads
    want = japi.sequence_normalization(jseq, 0, [3, 4, 5], "additive")
    got = tapi.sequence_normalization(tseq, 0, [3, 4, 5], "additive")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0] == 0.0


# ------------------------------------------------------------------- memory

def test_memory_budget_matches_jax(monkeypatch):
    monkeypatch.setattr(jmemory, "get_available_memory_mb", lambda: 4096)
    monkeypatch.setattr(tmemory, "get_available_memory_mb", lambda: 4096)
    for rx, n in ((640, 1000), (2048, 50), (4096, 100000)):
        assert tmemory.stacking_block_rows(rx, n) == jmemory.stacking_block_rows(rx, n)
        assert (tmemory.stacking_block_rows(rx, n, memory_percent=0.5, nthreads=4)
                == jmemory.stacking_block_rows(rx, n, memory_percent=0.5, nthreads=4))
    assert tmemory.get_device_memory_bytes("cpu") == 4096 << 20
    monkeypatch.undo()
    assert tmemory.get_available_memory_mb() > 0
    assert tmemory.get_device_memory_bytes(torch.device("cpu")) > 0
