"""siriltpu_torch.ops.shift / ops.stack / ops.stats and the stacking
API's normalization, against siriltpu's.

The same seeded NumPy inputs go to both packages. shift2d and the sum,
max and min stacks are bit-exact; the statistics are NumPy on both sides
and equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.ops import shift as jshift  # noqa: E402
from siriltpu.ops import stack as jstack  # noqa: E402
from siriltpu.ops import stats as jstats  # noqa: E402
from siriltpu.stacking import api as japi  # noqa: E402
from siriltpu_torch.ops import shift as tshift  # noqa: E402
from siriltpu_torch.ops import stack as tstack  # noqa: E402
from siriltpu_torch.ops import stats as tstats  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_numpy  # noqa: E402


def make_frames(f=6, c=3, h=20, w=28, seed=0, hi=65536):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, (f, c, h, w)).astype(np.uint16)


def shifts_for(f, bound=3, seed=1):
    return np.random.default_rng(seed).integers(
        -bound, bound + 1, (f, 2)).astype(np.int32)


@pytest.mark.parametrize("skip_origin", [False, True])
@pytest.mark.parametrize("sx,sy", [(0, 0), (3, -2), (-4, 5), (2, 0), (0, -1),
                                   (30, 0), (-7, -25)])
def test_shift2d_matches_jax(sx, sy, skip_origin):
    img = make_frames(1, 2, 11, 17)[0].astype(np.int32)
    for fill in (0, 65535):
        want = np.asarray(jshift.shift2d(jnp.asarray(img), sx, sy, fill=fill,
                                         skip_origin=skip_origin))
        got = tshift.shift2d(torch.from_numpy(img), sx, sy, fill=fill,
                             skip_origin=skip_origin)
        np.testing.assert_array_equal(got.numpy(), want)


def test_shift2d_skips_the_origin():
    img = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    out = tshift.shift2d(img, 1, 1, fill=0, skip_origin=True)
    assert int(out[1, 1]) == 0 and int(out[1, 2]) == 2 and int(out[2, 1]) == 5


@pytest.mark.parametrize("hi", [1200, 65536])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_stack_ops_match_jax(op, hi):
    """With hi = 65536 the sum of 6 frames exceeds 65535, so the exact f64
    rescale runs; with hi = 1200 it does not."""
    frames = make_frames(hi=hi, seed=hi)
    shifts = shifts_for(6)
    fn_j, fn_t = getattr(jstack, f"stack_{op}"), getattr(tstack, f"stack_{op}")
    want = fn_j(frames, shifts)
    got = fn_t(frames_from_numpy(frames, "cpu"), shifts)
    if op == "sum":
        (want, want_hi), (got, got_hi) = want, got
        assert got_hi == want_hi
        assert (want_hi == 65535) == (hi == 65536)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(u16_to_numpy(got), want)


def test_stack_ops_without_shifts():
    frames = make_frames(f=3, c=1, seed=9)
    for op in ("max", "min"):
        want = getattr(jstack, f"stack_{op}")(frames)
        got = getattr(tstack, f"stack_{op}")(frames_from_numpy(frames, "cpu"))
        np.testing.assert_array_equal(u16_to_numpy(got), want)


def _sky(f=5, c=3, h=32, w=40, seed=2, level=1000.0):
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(level, 40, (f, c, h, w))
                     + 30 * np.arange(f)[:, None, None, None], 0, 65535)
    return frames.astype(np.uint16)


@pytest.mark.parametrize("level", [100.0, 1000.0])
def test_statistics_extra_matches_jax(level):
    """level 100 is 8-bit data (normalized by 255), 1000 is 16-bit."""
    frames = _sky(level=level)
    for i in range(len(frames)):
        want = jstats.statistics(frames[i], 0, option=jstats.STATS_EXTRA)
        got = tstats.statistics(frames[i], 0, option=tstats.STATS_EXTRA)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("level", [100.0, 1000.0])
@pytest.mark.parametrize("mode", japi.NORM_MODES)
def test_normalization_matches_jax(mode, level):
    """IKSS from the device histograms gives the statistics' location and
    scale, and the coefficients of every mode are equal."""
    frames = _sky(level=level)
    jst = [jstats.statistics(frames[i], 0, option=jstats.STATS_EXTRA)
           for i in range(len(frames))]
    tst = tapi.ikss_stats(frames_from_numpy(frames, "cpu"), batch=2)
    for a, b in zip(jst, tst):
        assert (b.location, b.scale, b.norm_value) == (a.location, a.scale,
                                                       a.norm_value)
    for want, got in zip(japi.compute_normalization(jst, 0, mode),
                         tapi.compute_normalization(tst, 0, mode)):
        np.testing.assert_array_equal(got, want)
