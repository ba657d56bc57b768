"""Image formats, conversion, settings and undo of siriltpu_torch against
siriltpu and the compiled reference: ``io/formats.py``,
``io/conversion.py``, ``core/config.py``, ``core/undo.py`` and the
``Settings`` carrier of ``utils/interop.py``.

All of it is host code copied from the JAX package, so every comparison is
exact: files byte for byte (FITS but the value of its ``DATE`` card, the
time it was written), images word for word, settings field for field, and
``c_formats.bin`` as the JAX test holds it.
"""

import dataclasses
import os
import struct
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.cli import main as tmain  # noqa: E402
from siriltpu_torch.core import config as tconfig  # noqa: E402
from siriltpu_torch.core import undo as tundo  # noqa: E402
from siriltpu_torch.core.frame import Frame as TFrame  # noqa: E402
from siriltpu_torch.io import conversion as tconv  # noqa: E402
from siriltpu_torch.io import formats as tformats  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.cli import main
    from siriltpu.core import config, frame, undo
    from siriltpu.io import conversion, fits, formats, ser
    return SimpleNamespace(main=main, config=config, frame=frame, undo=undo,
                           conversion=conversion, fits=fits, formats=formats, ser=ser)


def fits_bytes(path) -> bytes:
    """A FITS file's bytes with the value of its DATE card blanked."""
    raw = bytearray(open(path, "rb").read())
    for off in range(0, len(raw), 80):
        if raw[off:off + 8] == b"DATE    ":
            raw[off + 10:off + 30] = b" " * 20
            break
    return bytes(raw)


def image(c: int, h: int, w: int, seed: int, hi: int = 65535) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, hi + 1, (c, h, w)).astype(np.uint16)


def dirs(tmp_path):
    j, t = tmp_path / "jax", tmp_path / "torch"
    j.mkdir()
    t.mkdir()
    return j, t


# ------------------------------------------------------------------ golden

def _blob(r):
    return r.take_bytes(r.take("q"))


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

    def take_bytes(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_formats.bin")),
                    reason="goldens not generated")
def test_formats_golden_vs_c(tmp_path):
    """c_formats.bin as tests/test_c_goldens.py holds the JAX package:
    readbmp, savebmp, saveppm/savepgm, import_pnm_to_fits, readpic."""
    r = _Reader("c_formats.bin")
    for case in range(4):
        p = tmp_path / f"a{case}.bmp"
        p.write_bytes(_blob(r))
        rv, rx, ry, nchan, bitpix = (r.take("i") for _ in range(5))
        planes = r.take_u16s(rx * ry * nchan)
        got = tformats.load_bmp(str(p))
        assert got.nlayers == nchan and (got.rx, got.ry) == (rx, ry)
        np.testing.assert_array_equal(got.data.ravel(), planes)
    for case in range(2):
        w, h, nchan = r.take("i"), r.take("i"), r.take("i")
        bufs = [np.frombuffer(_blob(r), np.uint8) for _ in range(3)]
        cfile = _blob(r)
        r8, g8, b8 = (b[::4].reshape(h, w) for b in bufs)
        if nchan == 1:
            g8 = b8 = r8
        p = tmp_path / f"b{case}.bmp"
        tformats.write_bmp24(str(p), r8, g8, b8)
        assert p.read_bytes() == cfile
    for nchan, name in ((3, "c.ppm"), (1, "c.pgm")):
        w, h = r.take("i"), r.take("i")
        img = r.take_u16s(w * h * nchan).reshape(nchan, h, w)
        cfile = _blob(r)
        tformats.save_pnm(str(tmp_path / name), TFrame(img))
        assert (tmp_path / name).read_bytes() == cfile
    for case in range(6):
        p = tmp_path / f"d{case}.pnm"
        p.write_bytes(_blob(r))
        if r.take("i") < 0:
            with pytest.raises(ValueError):
                tformats.load_pnm(str(p))
            continue
        rx, ry, nchan, bitpix = (r.take("i") for _ in range(4))
        planes = r.take_u16s(rx * ry * nchan)
        got = tformats.load_pnm(str(p))
        assert got.nlayers == nchan and (got.rx, got.ry) == (rx, ry)
        np.testing.assert_array_equal(got.data.ravel(), planes)
    for case in range(2):
        p = tmp_path / f"e{case}.pic"
        p.write_bytes(_blob(r))
        rv, rx, ry, binx, biny = (r.take("i") for _ in range(5))
        hi, lo = r.take("H"), r.take("H")
        planes = r.take_u16s(rx * ry * rv)
        got = tformats.load_pic(str(p))
        assert got.nlayers == rv and (got.rx, got.ry) == (rx, ry)
        assert (got.meta["binning_x"], got.meta["binning_y"]) == (binx, biny)
        assert (got.meta["hi"], got.meta["lo"]) == (hi, lo)
        np.testing.assert_array_equal(got.data.ravel(), planes)
    assert r.eof()


# ------------------------------------------------- the JAX package's files

@pytest.mark.parametrize("fmt", ["bmp", "pnm", "pic", "tif16", "tif8", "jpg"])
@pytest.mark.parametrize("nlayers", [1, 3])
def test_writers_and_readers_match_jax(jx, tmp_path, fmt, nlayers):
    """Each writer makes the JAX package's bytes (odd widths exercise the
    BMP row padding), and each reader reads the JAX package's file to the
    same words and header fields."""
    jd, td = dirs(tmp_path)
    data = image(nlayers, 13, 7 + nlayers, seed=nlayers)
    name = {"bmp": "x.bmp", "pnm": "x", "pic": "x.pic", "tif16": "x",
            "tif8": "x", "jpg": "x"}[fmt]
    for d, pkg, frame in ((jd, jx.formats, jx.frame.Frame), (td, tformats, TFrame)):
        path = str(d / name)
        if fmt == "bmp":
            pkg.save_bmp(path, frame(data))
        elif fmt == "pnm":
            pkg.save_pnm(path, frame(data))
        elif fmt == "pic":
            pkg.save_pic(path, frame(data))
        elif fmt == "jpg":
            pytest.importorskip("PIL")
            pkg.save_jpg(path, frame(data), 90)
        else:
            pytest.importorskip("PIL")
            pytest.importorskip("imageio")
            pkg.save_tiff(path, frame(data), bits=16 if fmt == "tif16" else 8)
    written = sorted(os.listdir(td))
    assert written == sorted(os.listdir(jd)) and len(written) == 1
    fname = written[0]
    assert (td / fname).read_bytes() == (jd / fname).read_bytes()
    got = tformats.load_any(str(jd / fname))
    want = jx.formats.load_any(str(jd / fname))
    np.testing.assert_array_equal(got.data, want.data)
    assert got.meta == want.meta
    if fmt == "pnm":
        np.testing.assert_array_equal(got.data, data)


def test_load_any_fits_and_unknown(jx, tmp_path):
    data = image(1, 6, 9, seed=4)
    jx.fits.write_fits(str(tmp_path / "f.fit"), jx.frame.Frame(data))
    np.testing.assert_array_equal(tformats.load_any(str(tmp_path / "f.fit")).data, data)
    (tmp_path / "junk.png").write_bytes(b"not an image")
    assert tformats.load_any(str(tmp_path / "junk.png")) is None
    assert jx.formats.load_any(str(tmp_path / "junk.png")) is None
    with pytest.raises(ValueError, match="magic"):
        (tmp_path / "bad.pic").write_bytes(b"\0" * 400)
        tformats.load_pic(str(tmp_path / "bad.pic"))


# ---------------------------------------------------------------- conversion

def write_inputs(jx, d, kind):
    """Conversion inputs: PNM, BMP and PIC images, or a mono and an RGB
    SER of a few frames, written by the JAX package."""
    if kind == "images":
        jx.formats.save_pnm(str(d / "a1.ppm"), jx.frame.Frame(image(3, 10, 12, 1)))
        jx.formats.save_pnm(str(d / "a2.pgm"), jx.frame.Frame(image(1, 10, 12, 2)))
        jx.formats.save_bmp(str(d / "b3.bmp"), jx.frame.Frame(image(3, 10, 12, 3)))
        jx.formats.save_pic(str(d / "c4.pic"), jx.frame.Frame(image(1, 10, 12, 4)))
        (d / "notes.txt").write_text("not converted")
    else:
        for name, color in (("m.ser", jx.ser.SER_MONO), ("r.ser", jx.ser.SER_BAYER_RGGB)):
            ser = jx.ser.SerFile.create(str(d / name), width=12, height=10,
                                        color_id=color)
            for i in range(3):
                ser.write_frame(jx.frame.Frame(image(1, 10, 12, 10 + i)))
            ser.write_and_close()


@pytest.mark.parametrize("kind", ["images", "ser"])
@pytest.mark.parametrize("flags", [{}, {"to_ser": True}, {"debayer": True}])
def test_convert_dir_matches_jax(jx, tmp_path, kind, flags):
    """convert_dir of PNM/BMP/PIC images or of SER files, to FITS or to one
    SER, debayered or not: the same count and the same files."""
    jd, td = dirs(tmp_path)
    write_inputs(jx, jd, kind)
    write_inputs(jx, td, kind)
    assert tconv.convertible_files(str(td)) == [
        p.replace(str(jd), str(td)) for p in jx.conversion.convertible_files(str(jd))]
    try:
        nj = jx.conversion.convert_dir(str(jd), "out", **flags)
    except ValueError as e:          # mixed geometry into one SER
        with pytest.raises(ValueError, match=str(e)):
            tconv.convert_dir(str(td), "out", device="cpu", **flags)
        return
    assert tconv.convert_dir(str(td), "out", device="cpu", **flags) == nj
    outs = sorted(n for n in os.listdir(jd) if n.startswith("out"))
    assert outs == sorted(n for n in os.listdir(td) if n.startswith("out"))
    assert outs
    for name in outs:
        if name.endswith(".fit"):
            assert fits_bytes(td / name) == fits_bytes(jd / name), name
        else:
            assert (td / name).read_bytes() == (jd / name).read_bytes(), name


def test_convert_dir_film_and_raw_name_their_module(jx, tmp_path, capsys):
    """The film and raw branches (once stubs of the port) on files no
    decoder reads, a truncated AVI and a NEF of zeros: both packages skip
    them with the same message and convert nothing; the film table is the
    JAX package's."""
    from siriltpu.io.films import FILM_EXTENSIONS
    assert tconv.FILM_EXTENSIONS == FILM_EXTENSIONS
    jd, td = dirs(tmp_path)
    for d in (jd, td):
        (d / "clip.avi").write_bytes(b"RIFF")
        (d / "IMG_1.NEF").write_bytes(b"\0" * 8)
    capsys.readouterr()
    assert jx.conversion.convert_dir(str(jd), "x") == 0
    want = capsys.readouterr().out
    assert tconv.convert_dir(str(td), "x", device="cpu") == 0
    assert capsys.readouterr().out == want.replace(str(jd), str(td))
    assert want.count("Skipping") == 2
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == ["IMG_1.NEF", "clip.avi"]


# ------------------------------------------------------------------ settings

SIRIL_CFG = (
    'working-directory = "/data/astro";\n'
    "libraw-settings :\n{\n  mul_0 = 1.5;\n  mul_2 = 1.25;\n  bright = 1.1;\n"
    "  auto = false;\n  cam_wb = true;\n  user_qual = 2;\n  gamm_0 = 2.2;\n};\n"
    "debayer-settings :\n{\n  ser_use_bayer_header = true;\n"
    "  pattern = 2;\n  compatibility = false;\n  inter = 2;\n};\n"
    "prepro-settings :\n{\n  cfa = true;\n};\n"
    "stacking-settings :\n{\n  method = 1;\n  rejection = 4;\n"
    "  normalisation = 3;\n  maxmem = 0.75;\n};\n"
    "photometry-settings :\n{\n  gain = 2.5;\n"
    "  inner-radius = 15.0;\n  outer-radius = 25.0;\n};\n"
    "// a comment\n"
    "misc-settings :\n{\n  swap_directory = \"/var/tmp\";\n"
    "  extension = \".fits\";\n};\n")


def test_settings_match_jax_and_cross(jx, tmp_path):
    """from_siril_cfg, the JSON save/load and the defaults give the JAX
    package's fields; a JAX Settings carried across field by field equals
    the port's, and each package loads the JSON the other saved."""
    cfg = tmp_path / "siril.cfg"
    cfg.write_text(SIRIL_CFG)
    t = tconfig.from_siril_cfg(str(cfg))
    j = jx.config.from_siril_cfg(str(cfg))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.debayer_pattern == "GBRG" and t.stack_rejection == "winsorized"
    assert interop.settings_from_fields(interop.config_to_fields(j)) == t
    assert dataclasses.asdict(tconfig.Settings()) == dataclasses.asdict(jx.config.Settings())
    j.stack_sigma_low, j.prepro_sigma = 2.5, (2.0, 4.0)
    j.save(str(tmp_path / "j" / "s.json"))
    got = tconfig.Settings.load(str(tmp_path / "j" / "s.json"))
    assert got == interop.settings_from_fields(interop.config_to_fields(j))
    got.save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j" / "s.json").read_text()
    assert tconfig.Settings.load(str(tmp_path / "missing.json")) == tconfig.Settings()
    # the CLI's -i routes .cfg files through the importer and the rest to JSON
    for init, want in ((str(cfg), t), (str(tmp_path / "t.json"), got)):
        st = tmain.make_state(str(tmp_path), init, device="cpu")
        assert st.settings == want and st.device == "cpu"
        js = jx.main.make_state(str(tmp_path), init)
        assert dataclasses.asdict(st.settings) == dataclasses.asdict(js.settings)


# ---------------------------------------------------------------------- undo

def test_undo_history_matches_jax(jx, tmp_path):
    """The same save/undo/redo sequence gives the same frames in both
    packages, the history keeps MAX_HISTORY snapshots, and flush removes
    every swap file."""
    assert tundo.MAX_HISTORY == jx.undo.MAX_HISTORY
    td, jd = tmp_path / "t", tmp_path / "j"
    td.mkdir()
    jd.mkdir()
    th, jh = tundo.UndoHistory(str(td)), jx.undo.UndoHistory(str(jd))
    frames = [image(1, 4, 5, seed=s) for s in range(tundo.MAX_HISTORY + 3)]
    for k, f in enumerate(frames[:-1]):
        th.save_state(TFrame(f, {"k": k}), f"op{k}")
        jh.save_state(jx.frame.Frame(f, {"k": k}), f"op{k}")
    assert len(os.listdir(td)) == len(os.listdir(jd)) == tundo.MAX_HISTORY
    cur_t, cur_j = TFrame(frames[-1]), jx.frame.Frame(frames[-1])
    for step in ("undo", "undo", "redo", "undo", "undo", "redo", "redo", "redo"):
        nt = getattr(th, step)(cur_t)
        nj = getattr(jh, step)(cur_j)
        if nj is None:
            assert nt is None
            continue
        np.testing.assert_array_equal(nt.data, nj.data)
        assert nt.meta == nj.meta
        cur_t, cur_j = nt, nj
    th.flush()
    jh.flush()
    assert os.listdir(td) == [] and os.listdir(jd) == []
    assert th.undo(cur_t) is None and th.redo(cur_t) is None


# -------------------------------------------------------------------- timing

@pytest.mark.parametrize("seconds", [0.0004, 0.25, 5, 59.9, 90, 3599, 7200])
def test_format_time_matches_jax(seconds):
    from siriltpu.utils.timing import format_time
    from siriltpu_torch.utils.timing import format_time as tformat_time
    assert tformat_time(seconds) == format_time(seconds)


def test_timed_and_device_trace(tmp_path):
    """``timed`` logs the reference's line; ``device_trace`` writes a
    torch.profiler Chrome trace of the block (on the CPU here)."""
    import json
    from siriltpu_torch.utils.timing import device_trace, timed
    logs = []
    with timed("op", log=logs.append):
        pass
    assert logs[0].startswith("Execution time [op]: ") and logs[0].endswith("ms")
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
