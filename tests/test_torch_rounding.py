"""siriltpu_torch.utils.rounding against siriltpu.utils.rounding and the
compiled reference (tests/goldens/c_rounding.bin)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.utils import rounding as jr  # noqa: E402
from siriltpu_torch.utils import rounding as tr  # noqa: E402

from test_c_goldens import GOLDEN_DIR, Reader  # noqa: E402


def _xs():
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.uniform(-300.0, 70000.0, 4000),
        np.arange(-3.0, 3.0, 0.25), np.arange(65533.0, 65537.0, 0.25),
        np.arange(253.0, 257.0, 0.25), [0.0, -0.5, 0.5, 65535.5, 255.5],
    ]).astype(np.float32)


@pytest.mark.parametrize("name", ["round_to_word", "round_to_word_f",
                                  "round_to_byte", "round_to_int"])
def test_f32_rounding_matches_jax(name):
    """The f32 device rule, element for element, dtype included."""
    xs = _xs()
    want = np.asarray(getattr(jr, name)(jnp.asarray(xs)))
    got = getattr(tr, name)(torch.from_numpy(xs))
    assert got.dtype == {"round_to_word": torch.uint16,
                         "round_to_word_f": torch.float32,
                         "round_to_byte": torch.uint8,
                         "round_to_int": torch.int32}[name]
    np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_rounding_vs_c():
    r = Reader(os.path.join(GOLDEN_DIR, "c_rounding.bin"))
    xs, rints, words, bytes_ = [], [], [], []
    while not r.eof():
        xs.append(r.take("d"))
        rints.append(r.take("i"))
        words.append(r.take("H"))
        bytes_.append(r.take("B"))
        r.take("B")  # conv_to_BYTE: display-only helper, not ported
    xs = np.asarray(xs)
    assert xs.size > 400
    np.testing.assert_array_equal(tr.np_round_to_int(xs), rints)
    np.testing.assert_array_equal(tr.np_round_to_word(xs),
                                  np.asarray(words, np.uint16))
    np.testing.assert_array_equal(tr.np_round_to_byte(xs),
                                  np.asarray(bytes_, np.uint8))
