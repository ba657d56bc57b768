"""The command line of siriltpu_torch against siriltpu's: ``cli/commands.py``,
``cli/main.py``, ``cli/state.py``, ``__main__.py``.

Every case of tests/test_cli.py runs here through both packages, on the
same seeded NumPy inputs written to two directories, one for each package.
Tolerances:

- files are compared byte for byte: FITS (but the value of its ``DATE``
  card, the time it was written), ``.seq``, SER, AVI, BMP, PNM, ``.lst``,
  ``.dat`` and ``.svg``; images word for word; logs line for line. That
  holds for every verb whose work is host NumPy, and for those on the
  device whose result is exact (integer DFT shifts, the sigma and median
  stacks, the Gaussian blur of ``gauss``);
- ``wavelet`` / ``wrecons``: the B-spline planes differ from the JAX
  package's by an ulp (XLA on the CPU contracts ``out + w * shifted`` into
  fused multiply-adds; tests/test_torch_starfind.py), and the weighted sum
  of ``wrecons`` is a matmul summed in another order, so the rebuilt words
  are held within 1 LSB of the JAX package's on under 1% of the pixels
  (and within 1 LSB of the input, the JAX test's bound);
- ``register global``: the two star finders' homographies differ by up to
  4e-4, so the ``r_`` frames are held within 3 LSB on 5% of the words, as
  tests/test_torch_global.py holds them;
- ``resample`` and ``rotate``: within 1 LSB on 0.5% and 0.1% of the words,
  as tests/test_torch_calibration.py holds ``resize`` and ``rotate``;
- ``findstar``, ``psf``, ``setmag``, ``register onestar``: the f32 LM fit's
  sums run in another order (tests/test_torch_starfind.py): positions within
  2e-3 px, magnitudes within 1e-3, FWHMs within 1e-3 relative; the shifts
  are equal.

The ``wavelet`` verb and the undo history write swap files into
``tempfile.gettempdir()`` under fixed names; each test points it at its own
``tmp_path``.
"""

import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.cli import commands as tcmd  # noqa: E402
from siriltpu_torch.cli import main as tmain  # noqa: E402
from siriltpu_torch.core.frame import Frame as TFrame  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import seqfile as tseqfile  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402

PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "siril-0.9_tpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.cli import commands, main
    from siriltpu.core import frame
    from siriltpu.io import fits, formats, seqfile, sequence, ser
    from siriltpu.testing import synth
    return SimpleNamespace(commands=commands, main=main, frame=frame, fits=fits,
                           formats=formats, seqfile=seqfile, sequence=sequence,
                           ser=ser, synth=synth)


@pytest.fixture(autouse=True)
def own_tempdir(tmp_path, monkeypatch):
    """The swap files of ``wavelet`` and of the undo history go to this
    test's directory (both packages read ``tempfile.gettempdir()``)."""
    swap = tmp_path / "swap"
    swap.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(swap))
    return swap


def fits_bytes(path) -> bytes:
    """A FITS file's bytes with the value of its DATE card blanked."""
    raw = bytearray(open(path, "rb").read())
    for off in range(0, len(raw), 80):
        if raw[off:off + 8] == b"DATE    ":
            raw[off + 10:off + 30] = b" " * 20
            break
        if raw[off:off + 8] == b"END     ":
            break
    return bytes(raw)


class Pair:
    """The same session in both packages, each in its own directory."""

    def __init__(self, jx, tmp_path, device="cpu"):
        self.jdir = tmp_path / "jax"
        self.tdir = tmp_path / "torch"
        self.jdir.mkdir()
        self.tdir.mkdir()
        self.jx = jx
        self.j = jx.main.make_state(str(self.jdir))
        self.t = tmain.make_state(str(self.tdir), device=device)

    def write(self, name, data):
        """The same FITS file into both directories."""
        self.jx.fits.write_fits(str(self.jdir / name), self.jx.frame.Frame(data))
        tfits.write_fits(str(self.tdir / name), TFrame(data))

    def run(self, line):
        rj = self.jx.commands.process_command(self.j, line)
        rt = tcmd.process_command(self.t, line)
        assert rt == rj, (line, rt, rj)
        return rt

    def same_image(self):
        if self.j.image is None:
            assert self.t.image is None
            return
        np.testing.assert_array_equal(self.t.image.data, self.j.image.data)

    def same_file(self, name):
        pj, pt = self.jdir / name, self.tdir / name
        assert pj.exists() and pt.exists(), name
        if name.endswith((".fit", ".fits", ".fts")):
            assert fits_bytes(pt) == fits_bytes(pj), name
        else:
            assert pt.read_bytes() == pj.read_bytes(), name

    def same_log(self):
        """The same lines, the directory's name aside."""
        assert [l.replace(str(self.tdir), "DIR") for l in self.t.log_lines] == \
            [l.replace(str(self.jdir), "DIR") for l in self.j.log_lines]


@pytest.fixture
def pair(jx, tmp_path):
    return Pair(jx, tmp_path)


def load_both(pair, data, name="img"):
    pair.write(name + ".fit", data)
    assert pair.run(f"load {name}") == 0


# ----------------------------------------------------------------- table

def test_command_table_matches_jax(jx):
    """The same verbs with the same argument counts and usage lines."""
    assert sorted(tcmd.COMMANDS) == sorted(jx.commands.COMMANDS)
    for verb, entry in jx.commands.COMMANDS.items():
        assert tcmd.COMMANDS[verb]["nbargs"] == entry["nbargs"], verb
        assert tcmd.COMMANDS[verb]["usage"] == entry["usage"], verb


def test_unknown_command(pair):
    assert pair.run("definitelynotacommand") == 1
    assert pair.run("stat") == 1          # no image: a clean error
    assert pair.run("iadd") == 1          # too few arguments: the usage line
    pair.same_log()


def test_load_stat_save(pair, jx):
    load_both(pair, jx.synth.noise_frame(16, 20, seed=1, mean=1000, sigma=10))
    assert pair.run("stat") == 0
    assert any("Mean" in l for l in pair.t.log_lines)
    assert pair.run("save out") == 0
    pair.same_file("out.fit")
    pair.same_log()


@pytest.mark.parametrize("line", ["iadd b", "isub b", "imul b", "idiv b",
                                  "fdiv b 2.5", "addmax b", "fmul 1.7",
                                  "offset -40", "threshlo 4990", "threshhi 5020",
                                  "thresh 4990 5020", "nozero 4995", "log",
                                  "mirrorx", "mirrory", "rotatepi",
                                  "shift 2 -3", "fill 7 1 2 3 4",
                                  "fill2 9 0 1 3 2", "fmedian 3 0.5",
                                  "fixbanding 1 3", "gauss 1.5",
                                  "unsharp 1.5 0.6", "ddp 5000 1 1.2"])
def test_arithmetic_roundtrip(pair, jx, line):
    """Each arithmetic, geometric and filter verb on the same image: the
    same words (iadd then isub restores the image, as the JAX test checks)."""
    data = jx.synth.noise_frame(8, 10, seed=2, mean=5000, sigma=100)
    load_both(pair, data, "a")
    pair.write("b.fit", np.full((1, 8, 10), 100, np.uint16))
    assert pair.run(line) == 0
    pair.same_image()
    if line == "iadd b":
        np.testing.assert_array_equal(
            pair.t.image.data, np.clip(data.astype(int) + 100, 0, 65535))
        assert pair.run("isub b") == 0
        np.testing.assert_array_equal(pair.t.image.data, data)


def test_measurement_verbs(pair, jx):
    """stat, bg, bgnoise, entropy, contrast, cdg and histo log the same
    lines and write the same histogram file."""
    data = jx.synth.noise_frame(32, 40, seed=12, mean=20000, sigma=3000, nlayers=3)
    load_both(pair, data)
    pair.run("boxselect 2 3 20 16")
    for line in ("stat", "bg", "bgnoise", "entropy", "contrast", "cdg",
                 "histo 1"):
        assert pair.run(line) == 0, line
    pair.same_file("histo_green.dat")
    pair.same_log()


def test_undo_redo(pair, jx):
    data = jx.synth.noise_frame(8, 8, seed=3)
    load_both(pair, data)
    pair.run("fmul 2.0")
    assert not np.array_equal(pair.t.image.data, data)
    pair.same_image()
    assert pair.run("undo") == 0
    np.testing.assert_array_equal(pair.t.image.data, data)
    assert pair.run("redo") == 0
    assert not np.array_equal(pair.t.image.data, data)
    pair.same_image()
    assert pair.run("redo") == 1            # nothing left to redo
    pair.same_log()


def test_crop_with_selection(pair, jx):
    load_both(pair, jx.synth.noise_frame(20, 30, seed=4))
    pair.run("boxselect 5 4 10 8")
    assert pair.run("crop") == 0
    assert (pair.t.image.rx, pair.t.image.ry) == (10, 8)
    assert pair.t.selection is None
    pair.same_image()


def test_fftd_ffti_roundtrip(pair, jx):
    data = jx.synth.noise_frame(16, 24, seed=5, mean=3000, sigma=500)
    load_both(pair, data)
    assert pair.run("fftd mod pha") == 0
    pair.same_file("mod.fit")
    pair.same_file("pha.fit")
    assert pair.run("ffti mod pha") == 0
    pair.same_image()
    err = np.abs(pair.t.image.data.astype(int) - data.astype(int)).max()
    assert err <= 1


def test_wavelet_wrecons_identity(pair, jx, own_tempdir):
    """wavelet, then wrecons from memory and from the .wave swap files
    (a fresh state) and extract: within 1 LSB of the input, and of the JAX
    package's words on under 1% of the pixels (module docstring)."""
    data = jx.synth.noise_frame(64, 64, seed=6, mean=2000, sigma=300)
    load_both(pair, data)
    assert pair.run("wavelet 3") == 0
    assert (own_tempdir / "r_rawdata.wave").exists()
    assert pair.run("wrecons 1 1 1") == 0
    err = np.abs(pair.t.image.data.astype(int) - data.astype(int)).max()
    assert err <= 1
    d = np.abs(pair.t.image.data.astype(int) - pair.j.image.data.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.01
    # a fresh port state rebuilds from the swap file the port wrote
    fresh = tmain.make_state(str(pair.tdir), device="cpu")
    assert tcmd.process_command(fresh, "load img") == 0
    assert tcmd.process_command(fresh, "wrecons 1 0.5 1") == 0
    ref = jx.main.make_state(str(pair.jdir))
    assert jx.commands.process_command(ref, "load img") == 0
    assert jx.commands.process_command(ref, "wrecons 1 0.5 1") == 0
    d = np.abs(fresh.image.data.astype(int) - ref.image.data.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.01
    assert pair.run("wavelet 9") == 1        # more planes than the size allows
    assert pair.run("extract 2") == 0
    for p in range(2):
        got = tfits.read_fits(str(pair.tdir / f"layer0_{p:02d}.fit")).data
        want = jx.fits.read_fits(str(pair.jdir / f"layer0_{p:02d}.fit")).data
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d != 0).mean() < 0.01, p


def star_image(jx, h=64, w=80, seed=13):
    """A sky near 1000 with 20 round stars, one bright at (40, 30)."""
    from siriltpu.testing.synth import gaussian_star
    img, _ = jx.synth.starfield(h, w, 20, seed=seed, noise_sigma=8.0,
                                amp_range=(3000, 20000), sigma_range=(2.0, 4.0))
    star = gaussian_star(h, w, 40.0, 30.0, 30000.0, 3.0, 3.0)
    return np.clip(img.astype(np.float64) + star, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("line", ["new 8 6 1", "visu 10 60000", "setcpu 2",
                                  "mtf 0.1 0.3 0.9", "histeq", "bgextract 2",
                                  "autostretch", "find_cosme_cfa 3 3",
                                  "clearstar", "unsetmag", "setmagseq 1.5",
                                  "unsetmagseq", "ls", "help"])
def test_host_verbs_match_jax(pair, jx, line):
    """The verbs whose work is host code: the same image, header fields and
    log lines."""
    load_both(pair, star_image(jx))
    assert pair.run(line) == 0
    pair.same_image()
    assert pair.t.image.meta == pair.j.image.meta
    assert pair.t.mag_offset == pair.j.mag_offset
    assert pair.t.settings == interop_settings(pair.j.settings)
    pair.same_log()


def interop_settings(settings):
    from siriltpu_torch.utils.interop import config_to_fields, settings_from_fields
    return settings_from_fields(config_to_fields(settings))


@pytest.mark.parametrize("line,lsb,share", [("rotate 5", 1, 1e-3),
                                            ("rotate 90", 0, 0.0),
                                            ("resample 0.5", 1, 5e-3),
                                            ("resample 1.7", 1, 5e-3)])
def test_resample_and_rotate_verbs(pair, jx, line, lsb, share):
    """resize and rotate on the device: as tests/test_torch_calibration.py
    holds them, within 1 LSB on a small share of the words (the matmul's
    and the sampler's sum orders differ from XLA's)."""
    load_both(pair, star_image(jx))
    assert pair.run(line) == 0
    got, want = pair.t.image.data, pair.j.image.data
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= lsb and (d != 0).mean() <= share, (d.max(), (d != 0).mean())
    assert pair.run("resample 9") == 1      # out of [0.1, 5]: a clean error


def test_star_verbs(pair, jx):
    """findstar, psf and setmag on the device: the same stars, and the fit
    within the LM fit's tolerance (tests/test_torch_starfind.py: positions
    2e-3 px, magnitudes 1e-3)."""
    load_both(pair, star_image(jx))
    assert pair.run("findstar") == 0
    assert len(pair.t.stars) == len(pair.j.stars) > 0
    for a, b in zip(pair.t.stars, pair.j.stars):
        assert abs(a.xpos - b.xpos) < 2e-3 and abs(a.ypos - b.ypos) < 2e-3
    assert pair.run("psf") == 1              # no selection: a clean error
    pair.run("boxselect 30 24 20 20")
    assert pair.run("psf") == 0
    assert pair.run("setmag 10") == 0
    assert abs(pair.t.mag_offset - pair.j.mag_offset) < 1e-3


def test_sequence_star_verbs(pair, jx):
    """seqpsf, register onestar and seqfind_cosme on a FITS sequence: the
    same shifts and cc_ files, and seqpsf's lines within the fit's
    tolerance."""
    shifts = [(0, 0), (2, -1), (-3, 2), (1, 3)]
    for i, (sx, sy) in enumerate(shifts):
        img = np.roll(star_image(jx, seed=13), (sy, sx), (1, 2))
        img[0, 5 + i, 7] = 60000                # a hot pixel for seqfind_cosme
        pair.write(f"st{i+1:02d}.fit", img)
    for line in ("seqload st", "seqfind_cosme 3 3", "boxselect 30 24 20 20",
                 "register onestar", "seqpsf"):
        assert pair.run(line) == 0, line
    for i in range(len(shifts)):
        pair.same_file(f"cc_st{i+1:02d}.fit")
    np.testing.assert_array_equal(pair.t.seq.reg_shifts(0), pair.j.seq.reg_shifts(0))
    np.testing.assert_array_equal(pair.t.seq.reg_shifts(0)[:, 0],
                                  [-sx for sx, _ in shifts])
    np.testing.assert_allclose([r.fwhm for r in pair.t.seq.regparam[0]],
                               [r.fwhm for r in pair.j.seq.regparam[0]], rtol=1e-3)


def test_find_hot_cosme_cycle(pair):
    rng = np.random.default_rng(7)
    dark = np.clip(rng.normal(500, 5, (1, 32, 32)), 0, 65535).astype(np.uint16)
    dark[0, 10, 12] = 60000
    load_both(pair, dark, "dark")
    assert pair.run("find_hot hotlist 3 3") == 0
    pair.same_file("hotlist.lst")
    light = np.clip(rng.normal(900, 5, (1, 32, 32)), 0, 65535).astype(np.uint16)
    light[0, 10, 12] = 65000
    load_both(pair, light, "light")
    assert pair.run("cosme hotlist.lst") == 0
    assert abs(int(pair.t.image.data[0, 10, 12]) - 900) < 60
    pair.same_image()
    assert pair.run("find_cosme 3 3") == 0
    pair.same_image()
    pair.same_log()


def test_sequence_pipeline_script(pair, jx):
    """register dft + stack through the command layer (config-3 shape)."""
    frames, _, gen = jx.synth.make_sequence_frames(6, 64, 64, seed=8)
    for i, f in enumerate(frames):
        pair.write(f"pl{i+1:03d}.fit", f)
    jx.sequence.check_seq(str(pair.jdir))
    tsequence.check_seq(str(pair.tdir))
    for line in ("seqload pl", "boxselect 8 8 48 48", "register dft",
                 "stack mean sigma 3 3"):
        assert pair.run(line) == 0, line
    pair.same_file("pl_stacked.fit")
    pair.same_image()
    seq = tseqfile.read_seqfile(str(pair.tdir / "pl.seq"))
    got = seq.reg_shifts(0)
    np.testing.assert_array_equal(got[:, 0], -(gen[:, 0] - gen[0, 0]))
    np.testing.assert_array_equal(
        got, jx.seqfile.read_seqfile(str(pair.jdir / "pl.seq")).reg_shifts(0))
    pair.same_file("pl.seq")
    # the sequence verbs that follow a registration
    for line in ("unselect 1 2", "select 2 2", "stack median",
                 "regplot", "seqcrop 4 4 40 32"):
        assert pair.run(line) == 0, line
    pair.same_file("pl_stacked.fit")
    pair.same_file("registration.dat")
    pair.same_file("registration.svg")
    pair.same_file("cropped_pl001.fit")
    pair.same_log()


def test_stackall(pair, jx):
    frames, _, _ = jx.synth.make_sequence_frames(3, 32, 32, seed=9,
                                                 shifts=np.zeros((3, 2), int))
    for i, f in enumerate(frames):
        pair.write(f"s{i+1:02d}.fit", f)
    assert pair.run("stackall") == 0
    pair.same_file("s_stacked.fit")


@pytest.mark.parametrize("flags", ["", " -ser"])
def test_convert_command(pair, jx, flags):
    for i in range(2):
        data = jx.synth.noise_frame(8, 8, seed=i, nlayers=3)
        jx.formats.save_pnm(str(pair.jdir / f"in{i}.ppm"), jx.frame.Frame(data))
        jx.formats.save_pnm(str(pair.tdir / f"in{i}.ppm"), jx.frame.Frame(data))
    assert pair.run("convert lights" + flags) == 0
    if flags:
        pair.same_file("lights.ser")
    else:
        pair.same_file("lights00001.fit")
        pair.same_file("lights00002.fit")
    pair.same_log()


def test_save_formats(pair, jx):
    load_both(pair, jx.synth.noise_frame(8, 8, seed=10, nlayers=3))
    # savebmp appends ".bmp" unconditionally like the reference
    # (command.c:246)
    for cmd, fname in [("savebmp out", "out.bmp"),
                       ("savejpg outj 90", "outj.jpg"),
                       ("savepnm outp", "outp.ppm"),
                       ("savetif outt", "outt.tif"),
                       ("savetif8 outt8", "outt8.tif")]:
        assert pair.run(cmd) == 0, cmd
        pair.same_file(fname)
    assert pair.run("split r g b") == 0
    for name in ("r.fit", "g.fit", "b.fit"):
        pair.same_file(name)


def test_script_runner(pair, jx, tmp_path):
    load_both(pair, jx.synth.noise_frame(8, 8, seed=11))
    script = tmp_path / "test.ssf"
    script.write_text("fmul 1.5\n# a comment\n\nsave scripted\n")
    assert tmain.run_script(pair.t, str(script)) == 0
    assert jx.main.run_script(pair.j, str(script)) == 0
    pair.same_file("scripted.fit")


def write_session_inputs(d):
    """The inputs of test_cli.py's scripted session (four shifted starfield
    frames plus a dark, as PPM files, and the master dark), made with NumPy
    and the port's writers, whose files equal the JAX package's byte for
    byte (tests/test_torch_formats.py)."""
    from siriltpu_torch.io.formats import save_pnm

    n, h, w = 4, 64, 64
    rng = np.random.default_rng(21)
    gen = rng.integers(-3, 4, size=(n, 2))
    gen[0] = 0
    stars = np.column_stack([rng.uniform(10, w - 10, 30), rng.uniform(10, h - 10, 30),
                             rng.uniform(2000, 40000, 30), rng.uniform(2, 8, 30)])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    dark = np.clip(rng.normal(150, 3, (1, h, w)), 0, 65535).astype(np.uint16)
    for i in range(n):
        img = np.full((h, w), 1000.0)
        for x0, y0, amp, sig in stars:
            dx, dy = xx - x0 - gen[i, 0], yy - y0 - gen[i, 1]
            img += amp * np.exp(-(dx * dx + dy * dy) / (2.0 * sig))
        img += rng.normal(0, 4.0, img.shape) + dark[0]
        raw = np.clip(np.rint(img), 0, 65535).astype(np.uint16)[None]
        save_pnm(os.path.join(d, f"raw{i+1:02d}.ppm"), TFrame(raw))
    tfits.write_fits(os.path.join(d, "master_dark.fit"), TFrame(dark))


SESSION = ("convert light\nseqload light\npreprocess -dark=master_dark\n"
           "seqload pp_light\nboxselect 8 8 48 48\nregister dft\n"
           "stack mean sigma 3 3\nautostretch\nsave final\n")


def test_full_scripted_session(pair, jx, tmp_path):
    """test_cli.py's scripted session through both packages: convert ->
    preprocess(dark) -> register -> sigma stack -> autostretch -> save.
    final.fit and pp_light_stacked.fit are equal byte for byte."""
    write_session_inputs(str(pair.jdir))
    write_session_inputs(str(pair.tdir))
    script = tmp_path / "sess.ssf"
    script.write_text(SESSION)
    assert tmain.run_script(pair.t, str(script)) == 0
    assert jx.main.run_script(pair.j, str(script)) == 0
    for name in ("final.fit", "pp_light_stacked.fit", "pp_light00001.fit",
                 "pp_light.seq"):
        pair.same_file(name)
    pair.same_log()


def test_every_command_fails_cleanly_without_state(tmp_path):
    """Each verb, invoked with no image/sequence loaded and zero args,
    either works or fails with a one-line error — never an exception,
    and never a touch of the device (the device here does not exist, so
    any tensor moved there would raise)."""
    skipped = {"exit", "quit"}
    for verb in sorted(tcmd.COMMANDS):
        if verb in skipped:
            continue
        state = tmain.make_state(str(tmp_path), device="cuda:99")
        tcmd.process_command(state, verb)


def test_register_global_verb_rgb_ser(jx, tmp_path):
    """The `register global` verb on an RGB SER writes the aligned r_ SER,
    within the module docstring's bound of the JAX package's."""
    from siriltpu.testing.synth import starfield

    h = w = 128
    rng = np.random.default_rng(31)
    base = np.column_stack([
        rng.uniform(20, w - 20, 15), rng.uniform(20, h - 20, 15),
        rng.uniform(9000, 28000, 15), rng.uniform(4, 6, 15)])
    pair = Pair(jx, tmp_path)
    for d in (pair.jdir, pair.tdir):
        ser = jx.ser.SerFile.create(f"{d}/rgbl.ser", width=w, height=h,
                                    color_id=jx.ser.SER_RGB)
        for i in range(4):
            st = base.copy()
            st[:, 0] += [0, 3, -4, 2][i]
            st[:, 1] += [0, -2, 3, -1][i]
            mono, _ = starfield(h, w, 15, seed=31, background=880,
                                noise_sigma=4.0, stars=st)
            ser.write_frame(jx.frame.Frame(np.repeat(mono, 3, axis=0)))
        ser.write_and_close()
    assert pair.run("seqload rgbl") == 0
    assert pair.run("register global") == 0
    rt = tsequence.ser_sequence(str(pair.tdir / "r_rgbl.ser"))
    rj = jx.sequence.ser_sequence(str(pair.jdir / "r_rgbl.ser"))
    assert rt.number == rj.number == 4
    for i in range(4):
        got, want = rt.read_frame(i).data, rj.read_frame(i).data
        assert got.shape == (3, h, w)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 3 and (d != 0).mean() <= 0.05, (i, d.max())


# ------------------------------------------ films, raw files and export

@pytest.mark.parametrize("case", ["seqexport", "seqload_film_name",
                                  "seqload_film_base", "convert_film",
                                  "convert_raw"])
def test_unported_verbs_name_their_module(pair, jx, case):
    """The verbs that wait for films, raw files and export (once stubs of
    the port): the same input to both packages gives the same return code,
    log and files. ``seqexport`` of a FITS sequence to an AVI; ``seqload``
    of a DIB AVI by its name and by its basename, then ``seqexport`` of it
    to a SER; ``convert`` of an MJPEG MP4 and of two CR2 files (the
    ``tests/test_cli.py`` case), as a CFA sequence and debayered."""
    from siriltpu.io import avi as javi, mp4 as jmp4
    from siriltpu.testing.cr2 import write_cr2 as jwrite_cr2
    from siriltpu_torch.io import avi as tavi, mp4 as tmp4
    from siriltpu_torch.testing.cr2 import write_cr2 as twrite_cr2
    rng = np.random.default_rng(40)
    frames = rng.integers(0, 256, (3, 1, 12, 18)).astype(np.uint16)
    sides = ((pair.jdir, jx.frame.Frame, javi, jmp4, jwrite_cr2),
             (pair.tdir, TFrame, tavi, tmp4, twrite_cr2))
    if case == "seqexport":
        for i, f in enumerate(frames):
            pair.write(f"e{i + 1:03d}.fit", f * 200)
        assert pair.run("seqload e") == 0
        lines, outs = ["seqexport movie avi 12 -norm"], ["movie.avi"]
    elif case.startswith("seqload"):
        for d, frame_cls, avi, _, _ in sides:
            wtr = avi.AviWriter(str(d / "night.avi"), 18, 12, fps=30.0)
            for f in frames:
                wtr.write_frame(frame_cls(f), 0, 255)
            wtr.close()
        name = "night.avi" if case.endswith("name") else "night"
        lines, outs = [f"seqload {name}", "seqexport cap ser"], ["cap.ser"]
    elif case == "convert_film":
        for d, frame_cls, avi, mp4, _ in sides:
            wtr = mp4.Mp4Writer(str(d / "clip.mp4"), 18, 12, 25.0)
            for f in frames:
                wtr.add_frame(avi._frame_to_jpeg(frame_cls(f), 90, 0, 255))
            wtr.close()
        lines, outs = ["convert lights"], [f"lights{k:05d}.fit" for k in (1, 2, 3)]
    else:
        cfas = rng.integers(0, 1 << 14, (2, 32, 48)).astype(np.uint16)
        for d, _, _, _, write_cr2 in sides:
            for k, cfa in enumerate(cfas):
                write_cr2(str(d / f"IMG_{k:04d}.CR2"), cfa)
        lines = ["convert lights", "convert rgb -debayer"]
        outs = [f"{b}{k:05d}.fit" for b in ("lights", "rgb") for k in (1, 2)]
    for line in lines:
        assert pair.run(line) == 0, line
    for name in outs:
        pair.same_file(name)
    pair.same_log()
    if case.startswith("seqload"):
        assert pair.t.seq.seqtype == pair.j.seq.seqtype == "film"
        assert pair.t.seq.number == 3
        for i in range(3):
            np.testing.assert_array_equal(pair.t.seq.read_frame(i).data, frames[i])
    if case == "convert_raw":
        got = tfits.read_fits(str(pair.tdir / "lights00001.fit"))
        np.testing.assert_array_equal(got.data[0], cfas[0][::-1])
        assert tfits.read_fits(str(pair.tdir / "rgb00002.fit")).nlayers == 3


# ------------------------------------------------------ python -m, no JAX

def test_module_entry_point_runs_without_jax(tmp_path):
    """``python -m siriltpu_torch --device cpu -d DIR -s SCRIPT`` runs the
    scripted session and exits 0, and the run imports neither JAX nor
    siriltpu, nor Pillow, imageio or matplotlib."""
    d = tmp_path / "run"
    d.mkdir()
    write_session_inputs(str(d))
    script = tmp_path / "sess.ssf"
    script.write_text(SESSION + "savebmp final\nsavepnm final\n")
    env = dict(os.environ, PYTHONPATH=PKG_ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "siriltpu_torch", "--device", "cpu", "-d", str(d),
         "-s", str(script)], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("final.fit", "final.bmp", "final.pgm", "pp_light_stacked.fit"):
        assert (d / name).exists(), name
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['siriltpu_torch', '--device', 'cpu', '-d', {str(d)!r},\n"
        "            '-c', 'load final', '-c', 'stat']\n"
        "try:\n"
        "    runpy.run_module('siriltpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'siriltpu', 'PIL', 'imageio', 'matplotlib')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Mean" in proc.stdout


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_scripted_session_matches_cpu(tmp_path):
    """The scripted session with ``device="cuda"`` writes the same
    final.fit and pp_light_stacked.fit as the CPU run, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stacks run the CUDA kernels")
    script = tmp_path / "sess.ssf"
    script.write_text(SESSION)
    dirs = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        write_session_inputs(str(d))
        state = tmain.make_state(str(d), device=dev)
        assert tmain.run_script(state, str(script)) == 0
        dirs[dev] = d
    for name in ("final.fit", "pp_light_stacked.fit"):
        assert fits_bytes(dirs["cuda"] / name) == fits_bytes(dirs["cpu"] / name)
