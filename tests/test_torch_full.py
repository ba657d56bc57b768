"""Post-processing and the BASELINE config-5 chain of siriltpu_torch against
siriltpu and the compiled reference: ``ops/background.py``,
``ops/histogram_ops.py``, ``ops/display.py``, ``parallel/engine.py`` and
``pipelines/full.py``.

Both packages get the same seeded NumPy frames (at most 128 x 160, 4
frames). Tolerances:

- background extraction, the MTF, the autostretch, histogram
  equalization and the display remaps are the same host NumPy float64
  code: tolerance 0, and ``c_gradient.bin`` / ``c_mtf.bin`` at the JAX
  tests' tolerances (the gradient model within 1 LSB on 1% of the words,
  the balance to 1e-12 relative, the stretched words exact);
- the engine: every frame mapped in order, and the JAX package's two
  faults pinned as repaired (a writer that dies while its queue is full
  makes ``map_frames`` raise within seconds; a run with a ``save_hook``
  keeps no output frame);
- ``config5_pipeline`` on a CFA SER (debayered on read) and on an RGB
  SER, with ``register_method="dft"``: every stage is exact in both
  packages (host NumPy, or integer shifts and an exact stack), so the
  ``bkg_`` SER is equal byte for byte and the output FITS's image word for
  word (its header holds the time it was written). With
  ``"global"`` the two star finders' homographies differ by up to 4e-4,
  so the ``r_`` frames differ by a few LSB (up to 6 seen) on a few percent
  of the words (tests/test_torch_global.py). PR 7's bound for the stack
  of such frames, 2 LSB, does not hold for every word of a winsorized
  stack of four: where one input moves by 1-3 LSB across the clip's edge,
  a value is rejected in one package and kept in the other, and the mean
  moves by up to a few hundred words (5 of 61440 words seen, the largest
  166). So each package's pre-stretch stack (the mean winsorized stack of
  its own ``r_`` frames) is held within 2 LSB on all but 0.1% of the
  words, and differs on at most 5% of them. The autostretch's (m, lo, hi)
  come from medians and MADs that such words do not move: equal. Each
  package's output is its own stack stretched (the chain composed by
  hand), so where the stacks are within 2 LSB the stretched words are
  within the stretch's own slope: 2 steps of its steepest step over the
  stack's range, plus 1 for the rounding (the MTF is steepest at the black
  point, ~(1-m)/m ≈ 100 words a word at m ≈ 0.01 here).
"""

import gc
import os
import struct
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import fits as tfits  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.ops import background as tbg  # noqa: E402
from siriltpu_torch.ops import display as tdisp  # noqa: E402
from siriltpu_torch.ops import histogram_ops as thist  # noqa: E402
from siriltpu_torch.parallel.engine import CancelledError, SequenceEngine  # noqa: E402
from siriltpu_torch.pipelines import full as tfull  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils import interop  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FH, FW, NFRAMES = 128, 160, 4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, the reference."""
    pytest.importorskip("jax")
    from siriltpu.core import frame
    from siriltpu.io import fits, sequence, ser
    from siriltpu.ops import background, display, histogram_ops
    from siriltpu.pipelines import full
    from siriltpu.stacking import api
    from siriltpu.testing import synth
    return SimpleNamespace(frame=frame, fits=fits, sequence=sequence, ser=ser,
                           background=background, display=display,
                           histogram_ops=histogram_ops, full=full, api=api,
                           synth=synth)


def make_sky(c: int, seed: int, h: int = FH, w: int = FW):
    """A tilted sky with stars and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 800 + 9.0 * xx + 5.0 * yy + rng.normal(0, 8, (c, h, w))
    img[:, rng.integers(0, h, 20), rng.integers(0, w, 20)] += 15000
    return np.clip(img, 0, 65535).astype(np.uint16)


# ------------------------------------------------------------- background

def test_background_matches_jax(jx):
    img = make_sky(3, 1)
    for order, box in ((1, 16), (2, 20), (4, 12)):
        p = jx.background.BackgroundParams(order=order, box=box)
        tp = interop.background_params_from_fields(interop.config_to_fields(p))
        assert tp == tbg.BackgroundParams(order=order, box=box)
        got = tbg.build_background_samples(img[1].astype(np.float64), tp)
        want = jx.background.build_background_samples(img[1].astype(np.float64), p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tbg.compute_background(img[0], tp),
                                      jx.background.compute_background(img[0], p))
        np.testing.assert_array_equal(tbg.extract_background(img, tp),
                                      jx.background.extract_background(img, p))
        np.testing.assert_array_equal(tbg.subtract_background(img, tp),
                                      jx.background.subtract_background(img, p))
    with pytest.raises(ValueError, match="not enough boxes"):
        tbg.build_background_samples(img[0].astype(np.float64),
                                     tbg.BackgroundParams(order=4, boxes_per_row=3,
                                                          boxes_per_col=3))


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

    def u16s(self, n, shape):
        a = np.frombuffer(self.buf, "<u2", n, self.off).reshape(shape).copy()
        self.off += 2 * n
        return a


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_gradient.bin")),
                    reason="c_gradient.bin not generated")
def test_background_vs_c_golden():
    r = _Reader("c_gradient.bin")
    ncases = 0
    while not r.eof():
        w, h, box = r.take("H"), r.take("H"), r.take("H")
        order = r.take("B") + 1            # POLY_1 enum value is 0
        bpr, bpc = r.take("H"), r.take("H")
        img = r.u16s(w * h, (h, w))
        n = bpr * bpc
        cxyv = np.array([r.take("ddd") for _ in range(n)])
        want_img = r.u16s(w * h, (h, w))
        p = tbg.BackgroundParams(order=order, box=box, boxes_per_row=bpr,
                                 boxes_per_col=bpc, tolerance=2.0, deviation=1.0,
                                 unbalance=0.8)
        cols, rows, vals = tbg.build_background_samples(img.astype(np.float64), p)
        np.testing.assert_array_equal(cols + box * 0.5, cxyv[:, 0])
        np.testing.assert_array_equal(h - rows + box * 0.5, cxyv[:, 1])
        np.testing.assert_array_equal(vals, cxyv[:, 2])
        got = tbg.extract_background(img[None], p)[0]
        d = np.abs(got.astype(int) - want_img.astype(int))
        assert d.max() <= 1 and (d != 0).mean() < 0.01, (ncases, d.max())
        ncases += 1
    assert ncases == 3


# ---------------------------------------------------------- histogram ops

def test_histogram_ops_and_display_match_jax(jx):
    img = make_sky(3, 2)
    dark = (img // 8).astype(np.uint16)
    for data in (img, dark, img[:1]):
        assert thist.find_midtones_balance(data) == jx.histogram_ops.find_midtones_balance(data)
        np.testing.assert_array_equal(thist.autostretch(data),
                                      jx.histogram_ops.autostretch(data))
        np.testing.assert_array_equal(thist.histeq(data), jx.histogram_ops.histeq(data))
        for mode in tdisp.MODES:
            np.testing.assert_array_equal(tdisp.remap(data, 700, 20000, mode),
                                          jx.display.remap(data, 700, 20000, mode))
    for m in (0.0, 0.5, 1.0, 0.07):
        np.testing.assert_array_equal(thist.mtf(np.linspace(0, 1, 11), m),
                                      jx.histogram_ops.mtf(np.linspace(0, 1, 11), m))
        np.testing.assert_array_equal(thist.apply_mtf(img[1], m, 0.01, 0.9),
                                      jx.histogram_ops.apply_mtf(img[1], m, 0.01, 0.9))
    np.testing.assert_array_equal(thist.apply_mtf(img[1] // 300, 0.2, 0.0, 1.0, norm=255.0),
                                  jx.histogram_ops.apply_mtf(img[1] // 300, 0.2, 0.0, 1.0,
                                                             norm=255.0))


@pytest.mark.skipif(not os.path.exists(os.path.join(GOLDEN_DIR, "c_mtf.bin")),
                    reason="c_mtf.bin not generated")
def test_mtf_autostretch_vs_c_golden():
    r = _Reader("c_mtf.bin")
    ncases = 0
    while not r.eof():
        nx, ny, nchan, _kind = r.take("H"), r.take("H"), r.take("B"), r.take("B")
        img = r.u16s(nchan * nx * ny, (nchan, ny, nx))
        m, lo, hi = r.take("ddd")
        out = r.u16s(nchan * nx * ny, (nchan, ny, nx))
        ncases += 1
        gm, glo, ghi = thist.find_midtones_balance(img)
        np.testing.assert_allclose(gm, m, rtol=1e-12, atol=0)
        np.testing.assert_allclose(glo, lo, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(ghi, hi, rtol=1e-12, atol=0)
        norm = 255.0 if img.max() <= 255 else 65535.0
        got = np.stack([thist.apply_mtf(img[c], m, lo, hi, norm=norm) for c in range(nchan)])
        np.testing.assert_array_equal(got.astype(np.uint16), out)
    assert ncases == 6


# ------------------------------------------------------------------ engine

def _seq(n: int):
    return tsequence.internal_sequence(
        [tframe.Frame(np.full((1, 4, 4), i, np.uint16)) for i in range(n)])


def test_engine_maps_in_order_with_stats():
    seq = _seq(13)
    seq.set_included(5, False)
    stats, seen, saved = {}, [], []
    eng = SequenceEngine(chunk=4, progress=lambda k, n: seen.append((k, n)))
    out = eng.map_frames(seq, lambda i, f: int(f.data[0, 0, 0]) * 10, stats=stats)
    assert out == [i * 10 for i in range(13) if i != 5]
    assert seen[-1] == (12, 12)
    assert stats["wall_s"] > 0 and set(stats) == {"read_s", "compute_s", "save_s",
                                                  "wall_s"}
    for async_save in (False, True):
        saved.clear()
        got = eng.map_frames(seq, lambda i, f: i * 2, filter_fn=lambda i: True,
                             save_hook=lambda i, out: saved.append((i, out)),
                             async_save=async_save)
        assert got == list(range(13))      # the indices mapped
        assert saved == [(i, i * 2) for i in range(13)]


def test_engine_cancellation():
    calls = []
    eng = SequenceEngine(chunk=2, cancel_check=lambda: len(calls) >= 3)
    with pytest.raises(CancelledError):
        eng.map_frames(_seq(10), lambda i, f: calls.append(i))
    assert calls == [0, 1, 2]


def test_engine_read_error_raises():
    seq = _seq(6)
    real = seq.read_frame

    def read(i):
        if i == 4:
            raise OSError("bad frame")
        return real(i)
    seq.read_frame = read
    with pytest.raises(OSError, match="bad frame"):
        SequenceEngine(chunk=2).map_frames(seq, lambda i, f: i)


def test_engine_dead_writer_with_full_queue_raises():
    """A save_hook that raises while the writer's queue is full: the JAX
    package's blocking put waited forever; here map_frames raises within
    seconds."""
    outcome = []

    def bad_save(i, out):
        time.sleep(0.3)        # the main thread fills the queue meanwhile
        raise OSError("disk full")

    def run():
        try:
            SequenceEngine(chunk=2).map_frames(_seq(40), lambda i, f: i,
                                               save_hook=bad_save, async_save=True)
        except OSError as e:
            outcome.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "map_frames hung on a dead writer"
    assert len(outcome) == 1 and "disk full" in str(outcome[0])


@pytest.mark.parametrize("async_save", (False, True))
def test_engine_with_save_hook_keeps_no_frame(async_save):
    """With a save_hook no output frame outlives its save: the JAX
    package kept every one in the returned list (144 MB an RGB frame of
    6144 x 4096)."""
    refs = []

    def hook(i, fr):
        out = tframe.Frame(fr.data + 1)
        refs.append(weakref.ref(out))
        return out

    got = SequenceEngine(chunk=3).map_frames(_seq(9), hook, save_hook=lambda i, out: None,
                                             async_save=async_save)
    assert got == list(range(9))
    gc.collect()
    assert len(refs) == 9 and all(r() is None for r in refs)


# ---------------------------------------------------------------- config 5

def build_ser(jx, path: str, cfa: bool):
    """Four RGB star frames with a sky gradient and known whole-pixel
    drifts, written as an RGB SER or mosaiced into an RGGB CFA SER."""
    h, w = FH, FW
    rng = np.random.default_rng(42)
    base = np.column_stack([
        rng.uniform(20, w - 20, 18), rng.uniform(20, h - 20, 18),
        rng.uniform(9000, 30000, 18), rng.uniform(3.5, 5.5, 18)])
    yy, xx = np.mgrid[0:h, 0:w]
    gradient = 0.06 * (xx * 65535 / w) + 0.03 * (yy * 65535 / h)
    color = jx.ser.SER_BAYER_RGGB if cfa else jx.ser.SER_RGB
    ser = jx.ser.SerFile.create(path, width=w, height=h, color_id=color)
    for i in range(NFRAMES):
        st = base.copy()
        st[:, 0] += [0, 3, -2, 4][i]
        st[:, 1] += [0, -2, 3, 1][i]
        mono, _ = jx.synth.starfield(h, w, 18, seed=42, background=700,
                                     noise_sigma=5.0, stars=st)
        rgb = np.clip(mono.astype(np.float64) * np.array([1.0, 0.9, 0.8])[:, None, None]
                      + gradient[None], 0, 65535).astype(np.uint16)
        if cfa:   # RGGB over the file's top-down rows
            td = rgb[:, ::-1]
            m = np.empty((h, w), np.uint16)
            m[0::2, 0::2] = td[0, 0::2, 0::2]
            m[0::2, 1::2] = td[1, 0::2, 1::2]
            m[1::2, 0::2] = td[1, 1::2, 0::2]
            m[1::2, 1::2] = td[2, 1::2, 1::2]
            ser.write_frame(jx.frame.Frame(np.ascontiguousarray(m[::-1])[None]))
        else:
            ser.write_frame(jx.frame.Frame(rgb))
    ser.write_and_close()


def _run_both(jx, tmp_path, cfa: bool, method: str):
    runs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "lights.ser")
        build_ser(jx, path, cfa)
        kw = dict(layer=1, rejection="winsorized", bg_order=2, register_method=method,
                  debayer=cfa)
        rep = (jx.full.config5_pipeline(path, **kw) if name == "jax"
               else tfull.config5_pipeline(path, device="cpu", **kw))
        runs[name] = SimpleNamespace(dir=d, rep=rep,
                                     out=tfits.read_fits(rep.output_path).data)
    return runs["jax"], runs["port"]


@pytest.mark.parametrize("cfa", (True, False), ids=("cfa", "rgb"))
def test_config5_dft_chain_equals_jax(jx, tmp_path, cfa):
    want, got = _run_both(jx, tmp_path, cfa, "dft")
    assert (got.rep.frames, got.rep.registered, got.rep.failed) == (NFRAMES, NFRAMES, 0)
    assert set(got.rep.stage_seconds) == {"convert", "bgextract", "register", "stack",
                                          "autostretch", "save"}
    assert got.rep.overlap_seconds["wall_s"] > 0
    assert got.rep.autostretch_m == want.rep.autostretch_m
    assert got.rep.rejection_percent == want.rep.rejection_percent
    assert (got.dir / "bkg_lights.ser").read_bytes() == (want.dir / "bkg_lights.ser").read_bytes()
    np.testing.assert_array_equal(got.out, want.out)   # the header holds a date
    assert got.out.shape == (3, FH, FW)


@pytest.mark.parametrize("cfa", (True, False), ids=("cfa", "rgb"))
def test_config5_global_chain_within_bound(jx, tmp_path, cfa):
    want, got = _run_both(jx, tmp_path, cfa, "global")
    assert (got.rep.registered, got.rep.failed) == (want.rep.registered, want.rep.failed)
    assert got.rep.registered == NFRAMES
    assert (got.dir / "bkg_lights.ser").read_bytes() == (want.dir / "bkg_lights.ser").read_bytes()
    # each package's pre-stretch stack of its own r_ frames
    stacks = {}
    for name, run, seq_mod, stack in (
            ("jax", want, jx.sequence, lambda fr: jx.api.stack_frames(
                fr, method="mean", rejection="winsorized")),
            ("port", got, tsequence, lambda fr: tapi.stack_frames(
                fr, device="cpu", method="mean", rejection="winsorized"))):
        rseq = seq_mod.ser_sequence(str(run.dir / "r_bkg_lights.ser"))
        stacks[name] = stack(np.stack([rseq.read_frame(i).data
                                       for i in range(rseq.number)])).data
    d = np.abs(stacks["port"].astype(np.int64) - stacks["jax"])
    assert (d > 2).mean() <= 1e-3 and (d != 0).mean() <= 0.05, (
        (d > 2).sum(), d.max(), (d != 0).mean())
    # each chain is its stages composed by hand (the pipeline adds wiring)
    np.testing.assert_array_equal(got.out, thist.autostretch(stacks["port"]))
    np.testing.assert_array_equal(want.out, jx.histogram_ops.autostretch(stacks["jax"]))
    assert got.rep.autostretch_m == want.rep.autostretch_m
    m, lo, hi = thist.find_midtones_balance(stacks["port"])
    assert (m, lo, hi) == jx.histogram_ops.find_midtones_balance(stacks["jax"])
    lut = thist.apply_mtf(np.arange(65536, dtype=np.uint16), m, lo, hi).astype(np.int64)
    for c in range(3):
        lo_v, hi_v = int(stacks["port"][c].min()), int(stacks["port"][c].max())
        step = int(np.diff(lut[max(lo_v - 2, 0):hi_v + 3]).max())
        dc = np.abs(got.out[c].astype(np.int64) - want.out[c])[d[c] <= 2]
        assert dc.max() <= 2 * step + 1, (c, dc.max(), step)
    med = np.median(got.out)
    assert 0.15 * 65535 < med < 0.40 * 65535


def test_config5_refuses_what_it_does_not_run(tmp_path):
    from siriltpu_torch.parallel.mesh import make_mesh

    # a mesh is taken (the run then fails on the missing file alone)
    with pytest.raises(FileNotFoundError):
        tfull.config5_pipeline(str(tmp_path / "x.ser"), device="cpu",
                               mesh=make_mesh(devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="register method"):
        tfull.config5_pipeline(str(tmp_path / "x.ser"), device="cpu",
                               register_method="ecc")
