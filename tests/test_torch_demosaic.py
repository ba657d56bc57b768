"""Demosaicing of siriltpu_torch against siriltpu and the compiled
reference: ``ops/demosaic.py`` and the debayering reads of ``io/ser.py``.

Both packages get the same seeded NumPy CFA frames (at most 120 x 160).
Tolerances:

- the host methods (super-pixel, bilinear, nearest, VNG, AHD) are the
  same NumPy code: tolerance 0, every method on every pattern, also on
  odd sizes (super-pixel's wrapped layout);
- ``vng_torch`` is integer torch ops, as ``_vng_jax_fn`` is integer jnp:
  tolerance 0 against both it and the NumPy ``vng``;
- ``ahd_torch`` is integer torch ops but for the float32 colour transform
  ahead of the CIELAB table. The JAX package's ``_ahd_jax_fn`` leaves two
  float32 spots (that transform and the chroma squares, PARITY.md #7); the
  port squares in int64 as the NumPy ``ahd`` does, and sums the transform
  as a chain of fused multiply-adds (emulated in float64), which is how
  NumPy's ``tensordot`` sums it here: tolerance 0 against the NumPy
  ``ahd``; against ``_ahd_jax_fn`` tolerance 0 wherever that program
  equals the NumPy ``ahd``, which it does not on a few words (at most 0.1%;
  its float32 chroma squares, 2 of 57600 seen). Where a BLAS sums
  ``tensordot`` in another order, a knife-edge can still move one word
  (the card is checked against the host that way in ``chip_smoke.py``);
- ``c_demosaic.bin`` at the JAX test's tolerances (0, AHD 1 LSB), through
  ``debayer_buffer`` and through the torch programs;
- the SER reads (whole frames and the expanded partial windows) equal the
  JAX package's for every method.

The ``cuda`` cases hold the card's ``debayer_buffer`` (VNG, and AHD) at
1024 x 1024 against the NumPy programs.
"""

import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import ser as tser  # noqa: E402
from siriltpu_torch.ops import demosaic as td  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy  # noqa: E402

METHODS = ("bilinear", "nearest", "vng", "ahd", "super_pixel")
PATTERNS = td.BAYER_PATTERNS
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "c_demosaic.bin")


@pytest.fixture(scope="module")
def jd():
    """The JAX package's demosaic and SER modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.core import frame
    from siriltpu.io import ser
    from siriltpu.ops import demosaic
    return demosaic, ser, frame


def make_cfa(h: int, w: int, seed: int) -> np.ndarray:
    """A CFA frame with a gradient, noise, saturated stars and black
    pixels: the interpolations' clamps and ties all fire."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 1500 + 40.0 * xx + 25.0 * yy + rng.normal(0, 60, (h, w))
    img[rng.integers(0, h, 25), rng.integers(0, w, 25)] = 65535
    img[rng.integers(0, h, 10), rng.integers(0, w, 10)] = 0
    return np.clip(img, 0, 65535).astype(np.uint16)


def tensor(cfa: np.ndarray):
    return frames_from_numpy(cfa, "cpu")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_debayer_buffer_matches_jax(jd, method, pattern):
    for k, (h, w) in enumerate(((120, 160), (37, 53))):
        cfa = make_cfa(h, w, seed=k)
        got = td.debayer_buffer(cfa, pattern, method, device="cpu")
        want = jd[0].debayer_buffer(cfa, pattern, method)
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{method} {pattern} {h}x{w}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_vng_torch_matches_jax_and_numpy(jd, pattern):
    jdemo = jd[0]
    import jax.numpy as jnp
    for k, (h, w) in enumerate(((120, 160), (67, 91))):
        cfa = make_cfa(h, w, seed=10 + k)
        got = u16_to_numpy(td.vng_torch(tensor(cfa), pattern))
        np.testing.assert_array_equal(got, td.vng(cfa, pattern))
        if k == 0:   # one shape: JAX compiles its program once a pattern
            np.testing.assert_array_equal(got, np.asarray(jdemo._vng_jax_fn(
                h, w, jdemo._VNG_FILTERS[pattern])(jnp.asarray(cfa))))
        np.testing.assert_array_equal(td.vng(cfa, pattern), jdemo.vng(cfa, pattern))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_ahd_torch_matches_jax_and_numpy(jd, pattern):
    jdemo = jd[0]
    import jax.numpy as jnp
    for k, (h, w) in enumerate(((120, 160), (67, 91))):
        cfa = make_cfa(h, w, seed=20 + k)
        got = u16_to_numpy(td.ahd_torch(tensor(cfa), pattern))
        host = td.ahd(cfa, pattern)
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(host, jdemo.ahd(cfa, pattern))
        if k:
            continue   # one shape: JAX compiles its program once a pattern
        want_jax = np.asarray(jdemo._ahd_jax_fn(h, w, jdemo._VNG_FILTERS[pattern])(
            jnp.asarray(cfa)))
        # the JAX device program parts from the host at its float32 spots
        # (PARITY.md #7); everywhere else the port equals it too
        jax_off = want_jax != host
        assert jax_off.mean() <= 1e-3, jax_off.sum()
        np.testing.assert_array_equal(got[~jax_off], want_jax[~jax_off])


def test_device_wrappers_and_dispatch(monkeypatch):
    """vng_device/ahd_device equal the torch programs; debayer_buffer sends
    VNG and AHD frames of 2^20 pixels or more to them on ``device`` (None
    refuses), smaller ones to the host; a failure there raises."""
    cfa = make_cfa(40, 56, seed=3)
    np.testing.assert_array_equal(td.vng_device(cfa, "GRBG", device="cpu"),
                                  td.vng(cfa, "GRBG"))
    np.testing.assert_array_equal(td.ahd_device(cfa, "GRBG", device="cpu"),
                                  td.ahd(cfa, "GRBG"))
    big = np.zeros((1024, 1024), np.uint16)
    calls = []
    for name in ("vng", "ahd"):
        monkeypatch.setattr(td, f"{name}_device",
                            lambda c, p, *, device, n=name: calls.append((n, device)) or n)
        assert td.debayer_buffer(big, "RGGB", name, device="cpu") == name
        with pytest.raises(ValueError, match="device"):
            td._on_device(td.vng_torch, big, "RGGB", None)
    assert calls == [("vng", "cpu"), ("ahd", "cpu")]
    monkeypatch.undo()

    def broken(*args):
        raise RuntimeError("device failure")
    monkeypatch.setattr(td, "vng_torch", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        td.debayer_buffer(big, "RGGB", "vng", device="cpu")


def _golden_cases():
    names = {0: "RGGB", 1: "BGGR", 2: "GBRG", 3: "GRBG"}
    methods = {0: "bilinear", 1: "nearest", 2: "vng", 3: "ahd", 4: "super_pixel"}
    buf = open(GOLDEN, "rb").read()
    off = 0
    while off < len(buf):
        w, h, method, pattern = struct.unpack_from("<HHBB", buf, off)
        off += 6
        img = np.frombuffer(buf, "<u2", w * h, off).reshape(h, w).copy()
        off += 2 * w * h
        ow, oh = struct.unpack_from("<HH", buf, off)
        off += 4
        out = np.frombuffer(buf, "<u2", 3 * ow * oh, off).reshape(oh, ow, 3).copy()
        off += 6 * ow * oh
        yield methods[method], names[pattern], img, np.moveaxis(out, -1, 0)


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="c_demosaic.bin not generated")
def test_demosaic_vs_c_golden():
    ncases = 0
    for method, pattern, img, want in _golden_cases():
        ncases += 1
        got = td.debayer_buffer(img, pattern, method, device="cpu")
        ctx = (method, pattern, img.shape)
        if method in ("vng", "ahd"):
            prog = td.vng_torch if method == "vng" else td.ahd_torch
            np.testing.assert_array_equal(u16_to_numpy(prog(tensor(img), pattern)),
                                          got, err_msg=str(ctx))
        if method == "ahd":
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, (ctx, diff.max())
        else:
            np.testing.assert_array_equal(got, want, err_msg=str(ctx))
    assert ncases == 60


def _write_cfa_ser(ser_mod, frame_mod, path, frames):
    s = ser_mod.SerFile.create(path, frames[0].shape[1], frames[0].shape[0],
                               color_id=ser_mod.SER_BAYER_RGGB)
    for fr in frames:
        s.write_frame(frame_mod.Frame(fr[::-1].copy()))
    s.write_and_close()


@pytest.mark.parametrize("method", METHODS)
def test_ser_debayer_reads_match_jax(jd, tmp_path, method):
    _, jser, jframe = jd
    frames = [make_cfa(48, 64, seed=30 + i) for i in range(2)]
    path = str(tmp_path / "cfa.ser")
    _write_cfa_ser(tser, tframe, path, frames)
    got_file, want_file = tser.SerFile.open(path), jser.SerFile.open(path)
    kw = dict(debayer=True, bayer_method=method)
    for i in range(2):
        got = got_file.read_frame(i, device="cpu", **kw)
        assert got.data.shape[0] == 3
        np.testing.assert_array_equal(got.data, want_file.read_frame(i, **kw).data)
    if method == "super_pixel":
        return   # a half-size frame: the partial reads' areas do not apply
    # areas at the borders, odd and even origins: every branch of the window
    # expansion (get_debayer_area)
    for x, y, w, h in ((0, 0, 64, 7), (3, 5, 20, 11), (10, 40, 33, 8), (1, 1, 62, 46)):
        for layer in range(3):
            np.testing.assert_array_equal(
                got_file.read_opened_partial(layer, 1, tframe.Rect(x, y, w, h),
                                             device="cpu", **kw),
                want_file.read_opened_partial(layer, 1, jframe.Rect(x, y, w, h), **kw),
                err_msg=f"{method} layer {layer} area {(x, y, w, h)}")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: VNG and AHD of a large frame run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ("vng", "ahd"))
def test_cuda_debayer_buffer_matches_numpy(cuda_device, method):
    """debayer_buffer at 1024 x 1024 (2^20 pixels: the device path) on the
    card against the NumPy program: VNG bit for bit; AHD too but for a
    knife-edge of the float32 colour transform where the host's BLAS sums
    in another order (at most 1 LSB on 1e-4 of the words)."""
    cfa = make_cfa(1024, 1024, seed=7)
    got = td.debayer_buffer(cfa, "RGGB", method, device=cuda_device)
    want = getattr(td, method)(cfa, "RGGB")
    d = np.abs(got.astype(np.int64) - want)
    if method == "vng":
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d != 0).mean() <= 1e-4, (d.max(), (d != 0).sum())
