"""siriltpu_torch.io.fits and io.ser against siriltpu's: every file written
by one package is read by the other to the same pixels and metadata, and
the files the two write from the same frames are equal byte for byte.

The inputs are small seeded NumPy arrays; the tolerance is 0 throughout.
"""

import datetime
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu.core import frame as jframe  # noqa: E402
from siriltpu.io import fits as jfits  # noqa: E402
from siriltpu.io import ser as jser  # noqa: E402
from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import ser as tser  # noqa: E402

H, W = 24, 40
#: (package name, its fits module, its ser module, its frame module)
PACKAGES = [("siriltpu", jfits, jser, jframe),
            ("siriltpu_torch", tfits, tser, tframe)]


def make_data(c: int, seed: int = 0, top: int = 65535) -> np.ndarray:
    rng = np.random.default_rng(seed + c)
    data = rng.integers(0, top + 1, (c, H, W)).astype(np.uint16)
    data[:, 0, :3] = (0, top, top // 2)
    return data


@pytest.fixture
def frozen_date(monkeypatch):
    """write_fits stamps the file with the current time: both packages see
    the same clock."""
    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2024, 2, 29, 12, 34, 56, tzinfo=tz)

    fake = types.SimpleNamespace(datetime=Fixed, UTC=datetime.UTC)
    monkeypatch.setattr(jfits, "datetime", fake)
    monkeypatch.setattr(tfits, "datetime", fake)


# ----------------------------------------------------------------------- FITS

META = {"exposure": 12.5, "date_obs": "2024-02-29T01:02:03", "instrume": "cam",
        "lo": 10, "hi": 60000, "dft_type": "SPECTRUM", "dft_ord": "CENTERED",
        "dft_norm": [1.5, None, 2.5], "dft_rx": 33, "dft_ry": 17}


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("bitpix", [8, 16])
def test_write_fits_bytes_equal_and_cross_read(tmp_path, frozen_date, bitpix, c):
    data = make_data(c, top=255 if bitpix == 8 else 65535)
    paths = {}
    for name, fits, _, frame in PACKAGES:
        paths[name] = str(tmp_path / f"{name}.fit")
        fits.write_fits(paths[name], frame.Frame(data, dict(META)), bitpix=bitpix)
    raw = {name: open(p, "rb").read() for name, p in paths.items()}
    assert raw["siriltpu"] == raw["siriltpu_torch"]
    assert len(raw["siriltpu"]) % 2880 == 0
    # each package reads the other's file
    for (_, fits, _, _), other in zip(PACKAGES, ("siriltpu_torch", "siriltpu")):
        got = fits.read_fits(paths[other])
        np.testing.assert_array_equal(got.data, data)
        assert got.meta["exposure"] == 12.5 and got.meta["hi"] == 60000
    assert (jfits.read_fits(paths["siriltpu_torch"]).meta
            == tfits.read_fits(paths["siriltpu"]).meta)
    assert (jfits.read_header(paths["siriltpu_torch"])
            == tfits.read_header(paths["siriltpu"]))
    # partial reads: an inner area, and full-width rows (read in one piece)
    for layer in range(c):
        for area in ((5, 3, 17, 9), (0, 7, W, 11), (0, 0, W, H)):
            want = jfits.read_fits_partial(paths["siriltpu_torch"], layer,
                                           jframe.Rect(*area))
            got = tfits.read_fits_partial(paths["siriltpu"], layer,
                                          tframe.Rect(*area))
            np.testing.assert_array_equal(got, want)
            x, y, w, h = area
            np.testing.assert_array_equal(
                got, data[layer][::-1][y:y + h, x:x + w])


def _raw_fits(bitpix: int, values: np.ndarray, bzero=None) -> bytes:
    """A FITS file of ``values`` (C, H, W) in the file's own type, built by
    hand: neither package writes BITPIX 32, -32 or signed 16."""
    c = values.shape[0]
    cards = [tfits._card("SIMPLE", True), tfits._card("BITPIX", bitpix),
             tfits._card("NAXIS", 3 if c == 3 else 2),
             tfits._card("NAXIS1", W), tfits._card("NAXIS2", H)]
    if c == 3:
        cards.append(tfits._card("NAXIS3", 3))
    if bzero is not None:
        cards += [tfits._card("BZERO", bzero), tfits._card("BSCALE", 1)]
    header = b"".join(cards) + b"END".ljust(80)
    header += b" " * (-len(header) % 2880)
    payload = values.astype(tfits._BITPIX_DTYPE[bitpix]).tobytes()
    return header + payload + b"\x00" * (-len(payload) % 2880)


#: (name, BITPIX, values of the file as a function of an rng, BZERO)
RAW_CASES = [
    ("long_small", 32, lambda r, s: r.integers(0, 60000, s), None),
    ("long_wide", 32, lambda r, s: r.integers(-2**31, 2**31 - 1, s), None),
    ("long_bzero", 32, lambda r, s: r.integers(-2**31, 2**31 - 1, s), 2**31),
    ("float_unit", -32, lambda r, s: r.random(s), None),
    ("float_word", -32, lambda r, s: r.random(s) * 70000 - 100, None),
    ("double_unit", -64, lambda r, s: r.random(s), None),
    ("short_signed", 16, lambda r, s: r.integers(-32768, 32768, s), None),
    ("byte", 8, lambda r, s: r.integers(0, 256, s), None),
]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name,bitpix,make,bzero", RAW_CASES,
                         ids=[case[0] for case in RAW_CASES])
def test_read_fits_every_bitpix_matches_jax(tmp_path, name, bitpix, make, bzero, c):
    values = make(np.random.default_rng(len(name) + c), (c, H, W))
    path = str(tmp_path / "raw.fit")
    with open(path, "wb") as f:
        f.write(_raw_fits(bitpix, values, bzero))
    want, got = jfits.read_fits(path), tfits.read_fits(path)
    assert got.data.dtype == np.uint16 and got.data.shape == (c, H, W)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.max() > 0
    assert got.meta == want.meta


def test_fits_errors_match_jax(tmp_path):
    path = str(tmp_path / "bad.fit")
    with open(path, "wb") as f:
        f.write(_raw_fits(-32, np.zeros((1, H, W)))[:2880 + 100])
    for fits in (jfits, tfits):
        with pytest.raises(ValueError, match="truncated FITS data"):
            fits.read_fits(path)
        with pytest.raises(ValueError, match="partial read only supported"):
            fits.read_fits_partial(path, 0, tframe.Rect(0, 0, 4, 4))
        with pytest.raises(ValueError, match="BYTE/USHORT"):
            fits.write_fits(path, tframe.Frame(make_data(1)), bitpix=32)


def test_frame_helpers_match_jax():
    data = make_data(3)
    meta = {"exposure": 2.5}
    want, got = jframe.Frame(data, dict(meta)), tframe.Frame(data, dict(meta))
    assert (got.nlayers, got.ry, got.rx, got.exposure) == (3, H, W, 2.5)
    assert (got.nlayers, got.ry, got.rx, got.exposure) == (
        want.nlayers, want.ry, want.rx, want.exposure)
    copy = got.copy()
    copy.data[0, 0, 0] ^= 1
    copy.meta["exposure"] = 0.0
    assert got.data[0, 0, 0] == data[0, 0, 0] and got.exposure == 2.5
    other = got.with_data(data[:1].astype(np.int32))
    assert other.data.dtype == np.uint16 and other.nlayers == 1
    assert other.meta == meta
    for cls in ("RegData", "ImgParam", "ImStats"):
        assert (vars(getattr(tframe, cls)()) == vars(getattr(jframe, cls)()))


# ------------------------------------------------------------------------ SER

def _write_ser(ser, frame, path, frames, **create):
    s = ser.SerFile.create(path, W, H, **create)
    for i, fr in enumerate(frames):
        s.write_frame(frame.Frame(fr))
        s.timestamps.append(1000 + 70 * i)
    s.write_and_close()
    return s


#: (name, colour id, bits, layers)
SER_CASES = [("mono16", jser.SER_MONO, 16, 1), ("mono8", jser.SER_MONO, 8, 1),
             ("rgb16", jser.SER_RGB, 16, 3), ("bgr8", jser.SER_BGR, 8, 3)]


@pytest.mark.parametrize("name,color,bits,c", SER_CASES,
                         ids=[case[0] for case in SER_CASES])
def test_ser_files_byte_equal_and_cross_read(tmp_path, name, color, bits, c):
    frames = [make_data(c, seed=i, top=255 if bits == 8 else 65535)
              for i in range(5)]
    paths = {}
    for pkg, _, ser, frame in PACKAGES:
        paths[pkg] = str(tmp_path / f"{pkg}.ser")
        _write_ser(ser, frame, paths[pkg], frames, color_id=color,
                   bit_pixel_depth=bits)
    raw = [open(p, "rb").read() for p in paths.values()]
    assert raw[0] == raw[1]
    assert len(raw[0]) == 178 + 5 * H * W * c * (bits // 8) + 5 * 8
    want_file = jser.SerFile.open(paths["siriltpu_torch"])
    got_file = tser.SerFile.open(paths["siriltpu"])
    assert vars(got_file.header) == vars(want_file.header)
    assert got_file.frame_count == 5
    assert got_file.timestamps == want_file.timestamps == [1000 + 70 * i for i in range(5)]
    assert got_file.fps == want_file.fps > 0
    for i in range(5):
        want, got = want_file.read_frame(i), got_file.read_frame(i)
        np.testing.assert_array_equal(got.data, want.data)
        # BGR planes are written as given and swapped on reading
        np.testing.assert_array_equal(
            got.data, frames[i][::-1] if color == jser.SER_BGR else frames[i])
        assert got.meta == want.meta
    for layer in range(c):
        for area in ((5, 3, 17, 9), (0, 7, W, 11), (0, 0, W, H)):
            want = want_file.read_opened_partial(layer, 2, jframe.Rect(*area))
            got = got_file.read_opened_partial(layer, 2, tframe.Rect(*area))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError):
        got_file.read_frame(5)


def test_ser_truncated_file_is_repaired_like_jax(tmp_path):
    """A capture that crashed left a frame count of 0 in the header: both
    packages count the whole frames in the file and rewrite the header. A
    wrong non-zero count is kept."""
    frames = [make_data(1, seed=i) for i in range(4)]
    paths = []
    for pkg, _, ser, frame in PACKAGES:
        path = str(tmp_path / f"{pkg}.ser")
        s = _write_ser(ser, frame, path, frames)
        s.header.frame_count = 0
        with open(path, "r+b") as f:
            f.write(s.header.pack())
            # half of the last frame and the timestamps are lost
            f.truncate(178 + 3 * H * W * 2 + H * W)
        paths.append(path)
    opened = [ser.SerFile.open(p) for (_, _, ser, _), p in zip(PACKAGES, paths)]
    assert [o.frame_count for o in opened] == [3, 3]
    # what is left of the last frame is read as the timestamp trailer
    assert opened[0].timestamps == opened[1].timestamps
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    # the repaired header is on disk
    assert tser.SerFile.open(paths[0]).frame_count == 3
    np.testing.assert_array_equal(opened[1].read_frame(2).data, frames[2])
    # a non-zero count on a short file stays, and the missing frame fails
    with open(paths[1], "r+b") as f:
        header = opened[1].header
        header.frame_count = 4
        f.write(header.pack())
    for ser in (jser, tser):
        short = ser.SerFile.open(paths[1])
        assert short.frame_count == 4
        with pytest.raises(ValueError, match="truncated SER frame"):
            short.read_frame(3)
    with pytest.raises(ValueError, match="truncated SER frame"):
        tser.SerFile.open(paths[1]).read_opened_partial(
            0, 3, tframe.Rect(0, 0, W, H))


def test_ser_inverted_endian_flag_matches_jax(tmp_path):
    """LittleEndian = 1 in the header means big-endian data (ser.h:32-42)."""
    frames = [make_data(1, seed=i) for i in range(2)]
    path = str(tmp_path / "big.ser")
    header = tser.SerHeader(width=W, height=H, frame_count=2, little_endian=1)
    with open(path, "wb") as f:
        f.write(header.pack())
        for fr in frames:
            f.write(fr[0, ::-1].astype(">u2").tobytes())
    assert header.pack() == jser.SerHeader(width=W, height=H, frame_count=2,
                                           little_endian=1).pack()
    want_file, got_file = jser.SerFile.open(path), tser.SerFile.open(path)
    for i in range(2):
        np.testing.assert_array_equal(got_file.read_frame(i).data, frames[i])
        np.testing.assert_array_equal(want_file.read_frame(i).data, frames[i])
        np.testing.assert_array_equal(
            got_file.read_opened_partial(0, i, tframe.Rect(3, 2, 9, 5)),
            want_file.read_opened_partial(0, i, jframe.Rect(3, 2, 9, 5)))
    # written back through the flag, the bytes are the same
    out = str(tmp_path / "out.ser")
    s = tser.SerFile.create(out, W, H)
    s.header.little_endian = 1
    for fr in frames:
        s.write_frame(tframe.Frame(fr))
    s.write_and_close()
    assert (open(out, "rb").read()[178:] == open(path, "rb").read()[178:])


def test_ser_cfa_reads_mono_and_debayer_names_its_roadmap_item(tmp_path):
    frames = [make_data(1, seed=i) for i in range(2)]
    path = str(tmp_path / "cfa.ser")
    _write_ser(tser, tframe, path, frames, color_id=tser.SER_BAYER_RGGB)
    want_file, got_file = jser.SerFile.open(path), tser.SerFile.open(path)
    np.testing.assert_array_equal(got_file.read_frame(1).data,
                                  want_file.read_frame(1).data)
    np.testing.assert_array_equal(
        got_file.read_opened_partial(0, 1, tframe.Rect(2, 2, 8, 8)),
        want_file.read_opened_partial(0, 1, jframe.Rect(2, 2, 8, 8)))
    # debayering on read is ported (ops/demosaic.py): equal to the JAX
    # package's, whole frames and the expanded partial window alike
    np.testing.assert_array_equal(got_file.read_frame(0, debayer=True, device="cpu").data,
                                  want_file.read_frame(0, debayer=True).data)
    np.testing.assert_array_equal(
        got_file.read_opened_partial(0, 0, tframe.Rect(2, 2, 8, 8), debayer=True,
                                     device="cpu"),
        want_file.read_opened_partial(0, 0, jframe.Rect(2, 2, 8, 8), debayer=True))


def test_ser_write_refuses_what_jax_refuses(tmp_path):
    for _, _, ser, frame in PACKAGES:
        path = str(tmp_path / "w.ser")
        s = ser.SerFile.create(path, W, H)
        with pytest.raises(ValueError, match="different size"):
            s.write_frame(frame.Frame(np.zeros((1, H + 1, W), np.uint16)))
        with pytest.raises(ValueError, match="layers"):
            s.write_frame(frame.Frame(np.zeros((3, H, W), np.uint16)))
        with pytest.raises(FileExistsError):
            ser.SerFile.create(path, W, H, overwrite=False)
        os.unlink(path)
