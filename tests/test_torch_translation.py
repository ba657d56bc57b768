"""siriltpu_torch.registration.translation.register_shift_dft against
siriltpu's, on a FITS sequence and on a SER sequence: the same shifts
exactly, the same qualities to 1e-12, the same best frame; and
ops.fftreg.register_shift_frames and ops.quality.normalize_quality, which
it calls.

The frames are one seeded star field drifted by known whole-pixel shifts,
written once to disk and opened by both packages.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu.core import frame as jframe  # noqa: E402
from siriltpu.io import fits as jfits  # noqa: E402
from siriltpu.io import sequence as jsequence  # noqa: E402
from siriltpu.io import ser as jser  # noqa: E402
from siriltpu.ops import fftreg as jfftreg  # noqa: E402
from siriltpu.ops import quality as jquality  # noqa: E402
from siriltpu.registration import translation as jtrans  # noqa: E402
from siriltpu_torch.core import frame as tframe  # noqa: E402
from siriltpu_torch.io import sequence as tsequence  # noqa: E402
from siriltpu_torch.ops import fftreg as tfftreg  # noqa: E402
from siriltpu_torch.ops import quality as tquality  # noqa: E402
from siriltpu_torch.registration import translation as ttrans  # noqa: E402

F, H, W, SIDE = 10, 96, 128, 64
#: the square selection, in top-down coordinates
SEL = (32, 16, SIDE, SIDE)


def make_drifted(seed: int = 0):
    """(F, 1, H, W) uint16 frames of one star field, frame i drifted by
    ``drift[i]`` = (dx, dy) whole pixels, and the (F, 2) registration
    shifts that undo the drift."""
    rng = np.random.default_rng(seed)
    pad = 12
    sky = rng.normal(1000, 15, (H + 2 * pad, W + 2 * pad))
    ys = rng.integers(pad, H + pad, 60)
    xs = rng.integers(pad, W + pad, 60)
    sky[ys, xs] += rng.uniform(15000, 50000, 60)
    sky[ys, xs + 1] += 8000
    drift = rng.integers(-7, 8, (F, 2))
    drift[0] = 0
    frames = [np.clip(sky[pad - dy:pad - dy + H, pad - dx:pad - dx + W]
                      + rng.normal(0, 8, (H, W)) + 3 * i, 0, 65535)
              for i, (dx, dy) in enumerate(drift)]
    return np.stack(frames).astype(np.uint16)[:, None], -drift.astype(np.int32)


def open_both(tmp_path, kind, frames):
    d = str(tmp_path)
    if kind == "ser":
        s = jser.SerFile.create(os.path.join(d, "cap.ser"), W, H)
        for fr in frames:
            s.write_frame(jframe.Frame(fr))
        s.write_and_close()
        return (jsequence.ser_sequence(os.path.join(d, "cap.ser")),
                tsequence.ser_sequence(os.path.join(d, "cap.ser")))
    for i, fr in enumerate(frames):
        jfits.write_fits(os.path.join(d, f"img{i + 1:04d}.fit"), jframe.Frame(fr))
    jseq = jsequence.check_seq(d)[0]
    return jseq, tsequence.check_seq(d)[0]


@pytest.mark.parametrize("kind", ["regular", "ser"])
def test_register_shift_dft_matches_jax(tmp_path, kind):
    frames, shifts = make_drifted()
    jseq, tseq = open_both(tmp_path, kind, frames)
    want = jtrans.register_shift_dft(jseq, 0, jframe.Rect(*SEL))
    got = ttrans.register_shift_dft(tseq, 0, tframe.Rect(*SEL), device="cpu",
                                    chunk=4)
    np.testing.assert_array_equal(tseq.reg_shifts(0), jseq.reg_shifts(0))
    # rows are bottom-up in both containers: the shifts undo the drift
    np.testing.assert_array_equal(tseq.reg_shifts(0), shifts)
    jq = np.array([r.quality for r in jseq.regparam[0]])
    tq = np.array([r.quality for r in tseq.regparam[0]])
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-12)
    assert tq.min() == 0.0 and tq.max() == 1.0
    assert got.best_frame == want.best_frame and got.failed == want.failed == 0
    assert tseq.needs_saving
    assert [vars(r) for r in tseq.regparam[0]] == [vars(r) for r in jseq.regparam[0]]


def test_register_shift_dft_included_frames_and_reference(tmp_path):
    """process_all_frames=False leaves the excluded frames' regdata as it
    was, and the shifts are relative to the reference image."""
    frames, shifts = make_drifted(seed=1)
    jseq, tseq = open_both(tmp_path, "ser", frames)
    for seq in (jseq, tseq):
        seq.set_included(3, False)
        seq.set_included(7, False)
        seq.reference_image = 2
    want = jtrans.register_shift_dft(jseq, 0, jframe.Rect(*SEL),
                                     process_all_frames=False)
    got = ttrans.register_shift_dft(tseq, 0, tframe.Rect(*SEL), device="cpu",
                                    process_all_frames=False)
    assert [vars(r) for r in tseq.regparam[0]] == [vars(r) for r in jseq.regparam[0]]
    assert got.best_frame == want.best_frame
    for i in (3, 7):
        assert vars(tseq.regparam[0][i]) == vars(tframe.RegData())
    incl = tseq.included_indices()
    np.testing.assert_array_equal(tseq.reg_shifts(0)[incl],
                                  (shifts - shifts[2])[incl])


def test_register_shift_dft_errors_and_unported(tmp_path):
    frames, _ = make_drifted()
    _, tseq = open_both(tmp_path, "ser", frames[:3])
    with pytest.raises(ValueError, match="squared"):
        ttrans.register_shift_dft(tseq, 0, tframe.Rect(0, 0, 64, 32), device="cpu")
    with pytest.raises(TypeError):
        ttrans.register_shift_dft(tseq, 0, tframe.Rect(*SEL))  # no device
    with pytest.raises(TypeError):
        ttrans.register_ecc(tseq, 0)  # ported (test_torch_ecc.py); no device


def test_register_shift_frames_matches_jax():
    frames, shifts = make_drifted(seed=2)
    sels = np.ascontiguousarray(frames[:, 0, 16:16 + SIDE, 32:32 + SIDE])
    wx, wy = jfftreg.register_shift_frames(sels[0], sels[1:], chunk=4)
    gx, gy = tfftreg.register_shift_frames(sels[0], sels[1:], chunk=4, device="cpu")
    assert gx.dtype == gy.dtype == np.int32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(np.stack([gx, gy], 1), shifts[1:])
    ex, ey = tfftreg.register_shift_frames(sels[0], sels[:0], device="cpu")
    assert ex.shape == ey.shape == (0,)
    with pytest.raises(ValueError, match="square"):
        tfftreg.register_shift_frames(sels[0][:, :32], sels[1:], device="cpu")


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 2.0, 5.0], [2.0, 2.0, 2.0], [1.0, float("nan"), 4.0]])
def test_normalize_quality_matches_jax(values):
    got = tquality.normalize_quality(np.array(values))
    np.testing.assert_array_equal(got, jquality.normalize_quality(np.array(values)))
