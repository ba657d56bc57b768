"""The benchmark's plain reference of linear-fit clipping
(``portbench/core/reference_linearfit.py``), which decides ``correct`` in
the ``linearfit`` cells, against the compiled reference C
(tests/goldens/c_rejection.bin) and the literal per-pixel oracle
(``verify.oracle.c_reject_block``) at tolerance 0, and its control (the
fit in float32) departing from it where the float32 fit is known to."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.core import reference_linearfit as lref  # noqa: E402
from portbench.core.reference import Precision  # noqa: E402

from test_c_goldens import REJ_NAMES, _read_rejection  # noqa: E402
from test_torch_linearfit_settle import FS, SIGS, oracle_words, settle_columns  # noqa: E402
from test_torch_reject_stack import knife_vals  # noqa: E402


def _u16(cols: np.ndarray):
    return torch.from_numpy(cols.view(np.int16)).view(torch.uint16)


def _words(mean) -> np.ndarray:
    return mean.view(torch.int16).to(torch.int64).numpy() & 0xFFFF


@pytest.mark.parametrize("sig", SIGS)
@pytest.mark.parametrize("F", FS)
def test_reference_matches_oracle(F, sig):
    cols = settle_columns(F, seed=3)
    want = oracle_words(cols, sig)
    mean, rejl, rejh = lref.reject_linearfit(_u16(cols), *sig, Precision())
    np.testing.assert_array_equal(_words(mean), want[0])
    np.testing.assert_array_equal(rejl.numpy(), want[1])
    np.testing.assert_array_equal(rejh.numpy(), want[2])


@pytest.mark.parametrize("n", [5, 8, 16, 33, 64, 128])
def test_reference_matches_compiled_c(n):
    """Every linearfit record of the compiled C with n values, through the
    blocked stack (blocks of 7 pixels): each mean, and the totals of both
    counters."""
    groups = {}
    for kind, _, nn, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == "linearfit" and nn == n:
            groups.setdefault((sig0, sig1), []).append((vec, mean, rej0, rej1))
    assert sum(len(v) for v in groups.values()) == 72
    for sig, items in groups.items():
        cols = np.stack([it[0] for it in items], axis=1).astype(np.uint16)
        mean, low, high = lref.stack(_u16(cols), sig, Precision(), block_values=7 * n)
        np.testing.assert_array_equal(_words(mean), [it[1] for it in items])
        assert (low, high) == (sum(it[2] for it in items), sum(it[3] for it in items))


def test_the_float32_control_departs():
    """The stage that carries the fit, one step down (float32), gives
    other words on knife-edge columns, where the float64 fit gives the
    oracle's."""
    cols = knife_vals(8, 3000, 1)
    sig = (2.0, 1.5)
    want = oracle_words(cols, sig)[0]
    assert lref.STAGE == "ikss" and Precision().ikss == "float64"
    control = Precision.below({"ikss": "float64"})
    assert control.ikss == "float32"
    exact = lref.stack(_u16(cols), sig, Precision())[0]
    low = lref.stack(_u16(cols), sig, Precision(ikss=control.ikss))[0]
    np.testing.assert_array_equal(_words(exact), want)
    assert (_words(low) != want).sum() > 0
