"""siriltpu_torch.pipelines.register_stack against
siriltpu.pipelines.register_stack: the align forms, and the whole
register + sigma-clip stack slice, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.pipelines import register_stack as jrs  # noqa: E402
from siriltpu.testing.synth import make_sequence_frames  # noqa: E402
from siriltpu_torch.pipelines import register_stack as trs  # noqa: E402
from siriltpu_torch.utils.interop import (frames_from_numpy,  # noqa: E402
                                          u16_to_numpy)
from siriltpu_torch.utils.timing import counters  # noqa: E402


@pytest.mark.parametrize("form", ["gather", "slice", "auto"])
@pytest.mark.parametrize("bound", [6, 64, 94, 200])
def test_align_matches_jax(form, bound):
    """Every align name equals JAX's gather align for shifts of up to 6
    pixels, and of up to 64, 94 and 200, which carry frames wholly out of
    the 40 x 56 frame. On the CPU none launches the align kernel."""
    f, h, w = 7, 40, 56
    rng = np.random.default_rng(bound)
    frames = rng.integers(0, 65536, (f, h, w)).astype(np.uint16)
    sx = rng.integers(-bound, bound + 1, f).astype(np.int32)
    sy = rng.integers(-bound, bound + 1, f).astype(np.int32)
    sx[0], sy[0] = bound, -bound
    want = np.asarray(jrs._align_frames_impl(
        jnp.asarray(frames), jnp.asarray(sx), jnp.asarray(sy)))
    fn = {"gather": trs.align_frames_gather, "slice": trs.align_frames_slice,
          "auto": trs.align_frames_auto}[form]
    before = counters().get("align.launches", 0)
    got = fn(frames_from_numpy(frames, "cpu"), torch.from_numpy(sx),
             torch.from_numpy(sy))
    assert counters().get("align.launches", 0) == before
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(u16_to_numpy(got), want)


def test_register_and_stack_matches_jax():
    """The slice end to end: 8 seeded 128x128 starfield frames through
    both packages. Shifts equal, stacked image bit-exact, quality at
    rtol 1e-5 (f32 gradient sums in another order)."""
    n, h, w = 8, 128, 128
    gen = np.random.default_rng(3).integers(-6, 7, size=(n, 2))
    gen[0] = 0
    frames, _, _ = make_sequence_frames(n, h, w, seed=3, shifts=gen,
                                        noise_sigma=6.0)
    mono = frames[:, 0]
    sel = (32, 32, 64)
    want_img, want_shifts, want_q = jrs.register_and_stack(
        jnp.asarray(mono), sel=sel, rejection="sigma", sig=(3.0, 3.0))
    img, shifts, q = trs.register_and_stack(
        frames_from_numpy(mono, "cpu"), sel=sel, rejection="sigma",
        sig=(3.0, 3.0))
    np.testing.assert_array_equal(shifts, want_shifts)
    np.testing.assert_array_equal(shifts, -gen)
    assert img.dtype == np.uint16 and img.shape == (h, w)
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_allclose(q, want_q, rtol=1e-5)

    dimg, (sx, sy), dq = trs.register_and_stack(
        frames_from_numpy(mono, "cpu"), sel=sel, return_device=True,
        with_quality=False)
    assert dq is None
    np.testing.assert_array_equal(u16_to_numpy(dimg), want_img)
    np.testing.assert_array_equal(sx.numpy(), want_shifts[:, 0])


@pytest.mark.parametrize("rejection,sig", [
    ("percentile", (0.2, 0.1)), ("sigmedian", (3.0, 3.0)),
    ("winsorized", (3.0, 3.0)), ("median", (0.0, 0.0)),
    ("linearfit", (3.0, 2.0))])
def test_register_and_stack_fused_rejections_match_jax(rejection, sig):
    """Every rejection with a kernel, and linearfit, through the whole
    slice, against JAX register_and_stack. JAX runs median only on the TPU
    (its CPU route has no median rejection), so the median stack is held
    to JAX's align and masked_median instead. linearfit is the plain f32
    fit in both packages (no exact re-run): tolerance 0 on every pixel
    that neither flags as a knife-edge."""
    from siriltpu.ops.rejection import masked_median, reject_linearfit
    from siriltpu_torch.ops.rejection import reject_linearfit as t_linearfit

    n, h, w = 8, 96, 96
    gen = np.random.default_rng(5).integers(-5, 6, size=(n, 2))
    gen[0] = 0
    frames, _, _ = make_sequence_frames(n, h, w, seed=5, shifts=gen,
                                        noise_sigma=6.0)
    mono = frames[:, 0]
    sel = (16, 16, 64)
    img, shifts, _ = trs.register_and_stack(
        frames_from_numpy(mono, "cpu"), sel=sel, rejection=rejection, sig=sig,
        with_quality=False)
    np.testing.assert_array_equal(shifts, -gen)
    if rejection == "median":
        aligned = jrs._align_frames_impl(jnp.asarray(mono), jnp.asarray(shifts[:, 0]),
                                         jnp.asarray(shifts[:, 1]))
        want_img = np.asarray(masked_median(
            aligned.reshape(n, h * w).astype(jnp.float32))).reshape(h, w)
    else:
        want_img, want_shifts, _ = jrs.register_and_stack(
            jnp.asarray(mono), sel=sel, rejection=rejection, sig=sig,
            with_quality=False)
        np.testing.assert_array_equal(shifts, want_shifts)
    if rejection == "linearfit":
        aligned = np.asarray(jrs._align_frames_impl(
            jnp.asarray(mono), jnp.asarray(shifts[:, 0]),
            jnp.asarray(shifts[:, 1]))).reshape(n, h * w).astype(np.float32)
        knife = (np.asarray(reject_linearfit(jnp.asarray(aligned), *sig)[4])
                 | t_linearfit(torch.from_numpy(aligned), *sig)[4].numpy())
        assert knife.mean() < 0.1
        img, want_img = img.reshape(-1)[~knife], want_img.reshape(-1)[~knife]
    np.testing.assert_array_equal(img, want_img)


def test_register_and_stack_rejects_unported_and_bad_selection():
    frames = frames_from_numpy(np.zeros((3, 32, 32), np.uint16), "cpu")
    with pytest.raises(ValueError, match="unknown rejection"):
        trs.register_and_stack(frames, sel=(0, 0, 16), rejection="bogus")
    with pytest.raises(ValueError):
        trs.register_and_stack(frames, sel=(20, 0, 16))


def test_small_bench_runs():
    bench = trs.RegisterStackBench(size=128, nframes=8, device="cpu")
    frames = bench.frames()
    assert frames.shape == (8, 128, 128) and frames.dtype == torch.uint16
    # the generated sequence is the shifted sky: frame i's content sits
    # at +shift, so registering recovers -shift
    _, shifts, _ = trs.register_and_stack(frames, sel=bench.sel,
                                          with_quality=False)
    np.testing.assert_array_equal(shifts, -bench.shifts)
