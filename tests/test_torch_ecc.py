"""ECC registration of siriltpu_torch against siriltpu and the compiled
reference aligner (tests/goldens/c_ecc.bin): ``ops/interp.py``,
``ops/ecc.py``, ``registration/translation.py:register_ecc``, and the
slice as a whole: ``register_ecc`` then ``stack_sequence`` with linear-fit
clipping on one small sequence through both packages.

Both packages get the same seeded NumPy inputs. Tolerances:

- the filters and samplers of ``ops/interp.py``: 0 (each tap is one f32
  product and one f32 sum, in the JAX package's order);
- the ECC iteration: its means, variances, Hessian and projections are
  f32 sums over the whole image, which torch and XLA order differently, so
  ``tx``, ``ty`` are held within 1e-3 px and ``rho`` within 1e-4 of
  siriltpu's (2e-5 px and 6e-7 were seen), a frame that fails in one
  fails in the other, and the integer shifts, the excluded frames and the
  float64 host qualities that ``register_ecc`` stores are equal;
- the golden: 0.05 px against the compiled C, the JAX test's own
  tolerance (tests/test_c_goldens.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.core import frame as jframe  # noqa: E402
from siriltpu.io import sequence as jsequence  # noqa: E402
from siriltpu.ops import ecc as jecc  # noqa: E402
from siriltpu.ops import interp as jinterp  # noqa: E402
from siriltpu.registration import translation as jtrans  # noqa: E402
from siriltpu.stacking import api as japi  # noqa: E402
from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.ops import ecc as tecc  # noqa: E402
from siriltpu_torch.ops import interp as tinterp  # noqa: E402
from siriltpu_torch.registration import translation as ttrans  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils import timing  # noqa: E402
from siriltpu_torch.utils.interop import sequence_to_fields  # noqa: E402

from test_c_goldens import GOLDEN_DIR, Reader  # noqa: E402

H, W = 96, 96


def field(seed: int, shape=(40, 56)) -> np.ndarray:
    return np.random.default_rng(seed).normal(100, 20, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["gaussian_blur5", "cv_gradient_x",
                                  "cv_gradient_y"])
def test_filters_match_jax(name):
    img = field(0)
    want = np.asarray(getattr(jinterp, name)(jnp.asarray(img)))
    got = getattr(tinterp, name)(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch is filtered frame by frame
    batch = torch.from_numpy(np.stack([img, field(1)]))
    np.testing.assert_array_equal(getattr(tinterp, name)(batch)[0].numpy(), want)


def test_sep_filter_matches_jax():
    img = field(2)
    kx, ky = (0.25, 0.5, 0.25), (0.1, 0.2, 0.4, 0.2, 0.1)
    want = jinterp.sep_filter(jnp.asarray(img), jnp.array(kx), jnp.array(ky))
    got = tinterp.sep_filter(torch.from_numpy(img), kx, ky)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["bilinear_sample", "nearest_sample"])
def test_samplers_match_jax(name):
    img = field(3)
    rng = np.random.default_rng(4)
    xs = rng.uniform(-3, 59, 500).astype(np.float32)
    ys = rng.uniform(-3, 43, 500).astype(np.float32)
    xs[:4], ys[:4] = (-1.0, 0.0, 55.0, 54.5), (0.0, -0.5, 39.0, 38.5)
    want = getattr(jinterp, name)(jnp.asarray(img), jnp.asarray(xs),
                                  jnp.asarray(ys), 7.0)
    got = getattr(tinterp, name)(torch.from_numpy(img), torch.from_numpy(xs),
                                 torch.from_numpy(ys), 7.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tx,ty", [(0.0, 0.0), (2.3, -1.7), (-0.5, 0.5),
                                   (60.0, 3.0)])
def test_translate_matches_jax(tx, ty):
    img = field(5)
    want = jinterp.translate_bilinear(jnp.asarray(img), tx, ty)
    got = tinterp.translate_bilinear(torch.from_numpy(img), tx, ty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tinterp.translate_mask(img.shape, tx, ty, device="cpu").numpy(),
        np.asarray(jinterp.translate_mask(img.shape, tx, ty)))


# ----------------------------------------------------------------- the ECC

def disc(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A bright planetary disc in the 8-bit range (it survives the
    reference's saturation to 8 bits), with 2 counts of noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 200.0 / (1 + np.exp(np.hypot(yy - h / 2, xx - w / 2) - h / 4))
    rng = np.random.default_rng(seed)
    return np.clip(d + rng.normal(0, 2, (h, w)) + 20, 0, 255).astype(np.uint16)


def drifted(ref: np.ndarray, drifts, seed: int) -> np.ndarray:
    """``ref`` displaced by each (dy, dx) with fresh noise of 2 counts."""
    rng = np.random.default_rng(seed)
    return np.stack([
        np.clip(np.roll(ref, d, axis=(0, 1)) + rng.normal(0, 2, ref.shape),
                0, 255).astype(np.uint16) for d in drifts])


DRIFTS = [(3, -2), (0, 0), (-7, 5), (12, 9), (1, 1), (-20, 17)]


def test_ecc_translation_batch_matches_jax():
    ref = disc(33)
    imgs = drifted(ref, DRIFTS, 34)
    # a frame of pure noise fails in both packages (rho = -1)
    imgs = np.concatenate([imgs, np.random.default_rng(35).integers(
        0, 255, (1, H, W)).astype(np.uint16)])
    want = [np.asarray(v) for v in jecc.ecc_translation_batch(
        jnp.asarray(ref, jnp.float32), jnp.asarray(imgs, jnp.float32))]
    got = [v.numpy() for v in tecc.ecc_translation_batch(
        torch.from_numpy(ref.astype(np.float32)),
        torch.from_numpy(imgs.astype(np.float32)))]
    ok = want[2] > 0
    assert ok.tolist() == [True] * len(DRIFTS) + [False]
    np.testing.assert_array_equal(got[2] > 0, ok)
    assert got[2][~ok] == want[2][~ok] == -1.0
    for name, g, w, tol in (("tx", got[0], want[0], 1e-3),
                            ("ty", got[1], want[1], 1e-3),
                            ("rho", got[2], want[2], 1e-4)):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=tol, err_msg=name)
    # the translation is the displacement of the content
    np.testing.assert_allclose(got[0][ok], [d[1] for d in DRIFTS], atol=0.15)
    np.testing.assert_allclose(got[1][ok], [d[0] for d in DRIFTS], atol=0.15)


def test_ecc_find_translation_matches_jax():
    ref = disc(36)
    img = drifted(ref, [(3, -2)], 37)[0] + np.uint16(300)   # saturates at 255
    want = jecc.ecc_find_translation(ref, img)
    got = tecc.ecc_find_translation(ref, img, device="cpu")
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    one = tecc.ecc_translation(torch.from_numpy(ref.astype(np.float32)),
                               torch.from_numpy(np.minimum(img, 255)
                                                .astype(np.float32)))
    assert [float(v) for v in one] == list(got)


def test_ecc_golden_vs_bundled_c():
    """The 10 planet-style fixtures of the reference's bundled aligner, at
    the JAX test's tolerance of 0.05 px, and against siriltpu at 1e-3."""
    r = Reader(os.path.join(GOLDEN_DIR, "c_ecc.bin"))
    ncase = 0
    while not r.eof():
        h, w = r.take("i"), r.take("i")
        r.take("d"), r.take("d")
        ref = r.take_u16s(h * w).reshape(h, w)
        img = r.take_u16s(h * w).reshape(h, w)
        ret = r.take("i")
        cdx, cdy = r.take("f"), r.take("f")
        ncase += 1
        assert ret == 0
        dx, dy, rho = tecc.ecc_find_translation(ref, img, device="cpu")
        assert rho > 0.9
        assert abs(dx - cdx) < 0.05 and abs(dy - cdy) < 0.05, (ncase, dx, dy)
        jdx, jdy, jrho = jecc.ecc_find_translation(ref, img)
        assert abs(dx - jdx) < 1e-3 and abs(dy - jdy) < 1e-3, (ncase, dx, jdx)
        assert abs(rho - jrho) < 1e-4
    assert ncase == 10


def both_sequences(frames: np.ndarray):
    """The same (F, H, W) frames as an internal sequence of each package."""
    return (jsequence.internal_sequence([jframe.Frame(f[None]) for f in frames]),
            tsequence.internal_sequence([tframe.Frame(f[None]) for f in frames]))


def assert_same_state(tseq, jseq):
    a, b = sequence_to_fields(tseq), sequence_to_fields(jseq)
    np.testing.assert_array_equal(a["incl"], b["incl"])
    np.testing.assert_array_equal(a["reg"][0], b["reg"][0])
    assert a["selnum"] == b["selnum"]


@pytest.mark.parametrize("all_frames", [True, False])
def test_register_ecc_matches_jax(all_frames):
    ref = disc(38, 80, 80)
    drifts = [(0, 0), (2, 1), (-3, 2), (1, -2), (9, -11), (4, 4)]
    frames = drifted(ref, drifts, 39)
    frames[0] = ref
    # frame 3 is the negative: ECC fails on it and it leaves the sequence
    frames[3] = 255 - ref
    jseq, tseq = both_sequences(frames)
    if not all_frames:
        for seq in (jseq, tseq):
            seq.set_included(5, False)
            seq.reference_image = 1
    want = jtrans.register_ecc(jseq, 0, process_all_frames=all_frames)
    timing.enable()
    try:
        got = ttrans.register_ecc(tseq, 0, device="cpu",
                                  process_all_frames=all_frames)
    finally:
        timing.disable()
    seconds = timing.totals(timing.collect())
    assert (got.best_frame, got.failed) == (want.best_frame, want.failed)
    assert got.failed == 1 and not tseq.imgparam[3].incl
    # shifts, qualities (f64 on the host) and the excluded set, all equal
    assert_same_state(tseq, jseq)
    assert tseq.needs_saving
    base = drifts[0 if all_frames else 1]
    for i in tseq.included_indices():
        dy, dx = drifts[i][0] - base[0], drifts[i][1] - base[1]
        assert tuple(tseq.reg_shifts(0)[i]) == (-dx, -dy), i
    # the stages' spans: reads, the device loop, the host quality
    assert min(seconds.values()) > 0 and set(seconds) == {
        "ecc.read", "ecc.device", "ecc.quality"}


@pytest.mark.parametrize("stream", [False, True])
def test_register_ecc_then_linearfit_stack_matches_jax(stream):
    """The slice as a whole: a drifting 8-bit disc registered by ECC, then
    stacked by the mean with linear-fit clipping and normalization, read
    whole and streamed; registration state, image and rejection counters
    equal siriltpu's."""
    rng = np.random.default_rng(41)
    ref = disc(42)
    drifts = [(0, 0)] + [tuple(d) for d in rng.integers(-6, 7, (11, 2))]
    frames = drifted(ref, drifts, 43)
    for i in range(1, 12, 3):     # outliers for the clip to find
        frames[i][rng.integers(0, H, 40), rng.integers(0, W, 40)] = 255
    jseq, tseq = both_sequences(frames)
    jtrans.register_ecc(jseq, 0)
    ttrans.register_ecc(tseq, 0, device="cpu")
    assert_same_state(tseq, jseq)
    assert tseq.reg_shifts(0).tolist() == [[-dx, -dy] for dy, dx in drifts]
    kw = dict(method="mean", rejection="linearfit", sig=(3.0, 2.0),
              normalize="additive_scaling", stream=stream)
    want = japi.stack_sequence(jseq, **kw)
    knife = timing.counters().get("linearfit.knife", 0)
    got = tapi.stack_sequence(tseq, device="cpu", block_rows=40, **kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.rejection_low, want.rejection_low)
    np.testing.assert_array_equal(got.rejection_high, want.rejection_high)
    assert got.rejection_low.sum() > 0 and got.rejection_high.sum() > 0
    assert timing.counters()["linearfit.knife"] > knife
    assert got.total_pixels == want.total_pixels
