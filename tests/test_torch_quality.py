"""siriltpu_torch.ops.quality against siriltpu.ops.quality, its own NumPy
anchor, and the compiled reference (tests/goldens/c_quality.bin)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.ops import quality as jq  # noqa: E402
from siriltpu.testing.synth import make_sequence_frames  # noqa: E402
from siriltpu_torch.ops import quality as tq  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy  # noqa: E402

from test_c_goldens import GOLDEN_DIR, Reader  # noqa: E402


@pytest.mark.parametrize("h,w", [(100, 100), (64, 97)])
def test_quality_batch_matches_jax(h, w):
    """rtol 1e-5: both sum the f32 gradient energy, in different orders
    (XLA's reduction tree vs torch's), so the last bits differ; every
    integer stage before it is exact."""
    frames, _, _ = make_sequence_frames(5, h, w, seed=h + w, noise_sigma=10.0)
    layers = frames[:, 0]
    want = np.asarray(jq.quality_estimate_batch(jnp.asarray(layers)))
    got = tq.quality_estimate_batch(frames_from_numpy(layers, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the f32 stretch factor can floor a pixel differently from the f64
    # anchor: the same 1e-3 the JAX package allows for its batch path
    anchor = [tq.quality_estimate(layers[i]) for i in range(5)]
    np.testing.assert_allclose(got.numpy(), anchor, rtol=1e-3)


def test_quality_batch_dark_frame_is_nan():
    """No pixel to stretch and none above the threshold: the gradient
    is -1 and sqrt gives NaN, as in the reference."""
    layers = np.zeros((2, 48, 48), np.uint16)
    got = tq.quality_estimate_batch(frames_from_numpy(layers, "cpu"))
    assert torch.isnan(got).all()


def test_quality_numpy_anchor_vs_c():
    """The copied NumPy anchor reproduces the compiled QualityEstimate."""
    r = Reader(os.path.join(GOLDEN_DIR, "c_quality.bin"))
    ncases = 0
    while not r.eof():
        nx, ny = r.take("H"), r.take("H")
        qtype = r.take("B")
        kind = r.take("B")
        img = r.take_u16s(nx * ny).reshape(ny, nx)
        want = r.take("d")
        ncases += 1
        np.testing.assert_allclose(tq.quality_estimate(img, qtype), want,
                                   rtol=1e-12, atol=1e-12,
                                   err_msg=str((nx, ny, qtype, kind)))
    assert ncases == 32
