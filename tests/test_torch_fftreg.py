"""siriltpu_torch.ops.fftreg against siriltpu.ops.fftreg and the compiled
reference's peak decode (tests/goldens/c_dftreg.bin)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.ops import fftreg as jfft  # noqa: E402
from siriltpu.testing.synth import make_sequence_frames  # noqa: E402
from siriltpu_torch.ops import fftreg as tfft  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy  # noqa: E402

from test_c_goldens import GOLDEN_DIR, Reader  # noqa: E402


@pytest.mark.parametrize("size,seed", [(64, 1), (96, 2)])
def test_phase_correlate_matches_jax(size, seed):
    """Seeded starfields shifted by known integers: both packages recover
    exactly the negated shifts (the FFTs round differently, so the
    surfaces are not compared bit for bit, only their decoded peaks)."""
    n = 7
    gen = np.random.default_rng(seed).integers(-9, 10, size=(n, 2))
    gen[0] = 0
    frames, _, _ = make_sequence_frames(n, size, size, seed=seed, shifts=gen,
                                        noise_sigma=5.0)
    sels = frames[:, 0]
    jsx, jsy = jfft.phase_correlate(jfft._ref_fft(jnp.asarray(sels[0])),
                                    jnp.asarray(sels))
    t = frames_from_numpy(sels, "cpu")
    tsx, tsy = tfft.phase_correlate(tfft._ref_fft(t[0]), t)
    assert tsx.dtype == torch.int32 and tsy.dtype == torch.int32
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsy.numpy(), np.asarray(jsy))
    np.testing.assert_array_equal(tsx.numpy(), -gen[:, 0])
    np.testing.assert_array_equal(tsy.numpy(), -gen[:, 1])


def test_decode_corr_peak_vs_c():
    """The first-maximum scan and wrap-around decode on every compiled
    reference surface (random, planted wrap-around peaks, ties,
    all-negative, constant, index-0 peak)."""
    r = Reader(os.path.join(GOLDEN_DIR, "c_dftreg.bin"))
    for case in range(3 * 12):
        size = r.take("H")
        corr = np.frombuffer(r.buf, "<f8", size * size, r.off).reshape(size, size)
        r.off += 8 * size * size
        want = (r.take("i"), r.take("i"))
        assert tfft.decode_corr_peak(corr) == want, (size, case)
        assert tfft.decode_corr_peak(torch.from_numpy(corr.copy())) == want
        assert jfft.decode_corr_peak(corr) == want
