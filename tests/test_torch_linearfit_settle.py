"""The float64 settle of linear-fit clipping
(``siriltpu_torch.ops.rejection.linearfit_settle``) against the compiled
reference C (tests/goldens/c_rejection.bin) and the literal per-pixel
oracle (``verify.oracle.c_reject_block``), at tolerance 0 on the mean and
both counters.

The seeded columns hold the quirks the settle has to reproduce: the scan
that breaks once N - r <= 4, the stale flags the removal reads past the
break (values removed and not counted), ties, all-equal columns and
columns whose sigma is 0. The file imports neither JAX nor ``siriltpu``,
so its ``cuda`` case runs on a machine with a card and without JAX:

    PYTHONPATH=siril-0.9_tpu python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_linearfit_settle.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.ops.rejection import (linearfit_exact,  # noqa: E402
                                          linearfit_settle)
from siriltpu_torch.verify import oracle  # noqa: E402

from test_c_goldens import REJ_NAMES, _read_rejection  # noqa: E402

SIGS = [(3.0, 3.0), (2.0, 1.5)]
FS = [4, 5, 8, 50, 128]


def settle_columns(f: int, seed: int) -> np.ndarray:
    """(F, K) uint16: noise around 1000 with a few cold and hot outliers,
    ramps with outliers, geomspace columns that clip down to the break,
    columns of three repeated levels (ties), all-equal columns, exact
    ramps (sigma 0) and uniform words."""
    rng = np.random.default_rng(7000 + 13 * f + seed)
    cols = []
    for _ in range(40):
        c = rng.normal(1000, 30, f)
        c[rng.integers(0, f, rng.integers(1, 4))] = rng.choice([0, 60000, 65535])
        cols.append(c)
    for _ in range(20):
        c = 800 + rng.uniform(5, 40) * np.arange(f) + rng.normal(0, 20, f)
        c[rng.integers(0, f, 2)] = rng.integers(0, 65536, 2)
        cols.append(c)
    for e in np.linspace(1, 4, 8):
        cols.append(np.geomspace(1, 65535, f) ** (1 / e) * 65535 ** (1 - 1 / e))
    for _ in range(12):
        cols.append(rng.integers(0, 3, f) * 1000 + rng.integers(0, 2, f))
    cols += [np.full(f, 777), np.zeros(f), np.full(f, 65535),
             100 + 3 * np.arange(f)]
    for _ in range(8):
        cols.append(rng.integers(0, 65536, f))
    return np.stack([np.clip(c, 0, 65535).astype(np.uint16) for c in cols], axis=1)


def oracle_words(cols: np.ndarray, sig):
    """The oracle on every column: (mean, rejl, rejh, survivors) int64
    NumPy arrays."""
    out = np.zeros((4, cols.shape[1]), np.int64)
    for j in range(cols.shape[1]):
        surv, rej = oracle.c_reject_block(cols[:, j], "linearfit", sig)
        mean = surv.astype(np.float64).sum() / surv.size if surv.size else 0.0
        out[:, j] = int(oracle.np_round_to_word(mean)), rej[0], rej[1], surv.size
    return out


def _ints(x):
    return x.cpu().to(torch.int64).numpy()


@pytest.mark.parametrize("sig", SIGS)
@pytest.mark.parametrize("F", FS)
def test_settle_matches_oracle(F, sig):
    """Tolerance 0 on (F, K) CPU tensors, uint16 and int32 alike; past
    F = 4, at (2, 1.5), the columns must show the break and its stale
    flags."""
    cols = settle_columns(F, seed=int(sig[1] * 10))
    want = oracle_words(cols, sig)
    got = linearfit_settle(torch.from_numpy(cols.view(np.int16)).view(torch.uint16), sig)
    assert got[0].dtype == torch.uint16 and got[1].dtype == torch.int32
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), w, err_msg=name)
    again = linearfit_settle(torch.from_numpy(cols.astype(np.int32)), sig)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(_ints(g), _ints(a))
    if sig == SIGS[1] and F > 4:
        # (3, 3) clips nothing at the smallest F, and at F = 4 the scan
        # breaks after rank 0 on every pass; (2, 1.5) reaches the break,
        # and past it the stale flags remove values uncounted
        counted = want[1] + want[2]
        assert (counted > 0).any() and (counted == 0).any()
        assert (want[3] - counted <= 4).any(), "no column reached the break"
        assert (F - want[3] > counted).any(), "no stale flag removed a value"


@pytest.mark.parametrize("n", [5, 8, 16, 33, 64, 128])
def test_settle_matches_compiled_c(n):
    """Every linearfit record of the compiled C with n values: the mean and
    both counters at tolerance 0, and ``linearfit_exact`` (the settle's
    NumPy face) the same."""
    groups = {}
    for kind, _, nn, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == "linearfit" and nn == n:
            groups.setdefault((sig0, sig1), []).append((vec, mean, rej0, rej1))
    assert sum(len(v) for v in groups.values()) == 72
    for sig, items in groups.items():
        cols = np.stack([it[0] for it in items], axis=1)
        got = linearfit_settle(torch.from_numpy(cols.astype(np.int32)), sig)
        face = linearfit_exact(cols, sig)
        assert face[0].dtype == np.uint16 and face[1].dtype == np.int32
        for col, name, g, e in zip((1, 2, 3), ("mean", "rejl", "rejh"), got, face):
            want = [it[col] for it in items]
            np.testing.assert_array_equal(_ints(g), want, err_msg=f"{name} sig={sig}")
            np.testing.assert_array_equal(e, want, err_msg=f"{name} sig={sig}")


def test_settle_of_no_column():
    got = linearfit_settle(torch.zeros((50, 0), dtype=torch.int32), (3.0, 3.0))
    assert [tuple(g.shape) for g in got] == [(0,), (0,), (0,)]
    face = linearfit_exact(np.zeros((50, 0), np.uint16), (3.0, 3.0))
    assert [a.shape for a in face] == [(0,), (0,), (0,)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("F", FS)
def test_cuda_settle_matches_oracle(cuda_device, F):
    """On the card: the words and counters of the oracle, on the device.
    CUDA divides a tensor by a host scalar through its reciprocal, which
    the settle must never do."""
    sig = SIGS[0]
    cols = settle_columns(F, seed=30)
    want = oracle_words(cols, sig)
    got = linearfit_settle(torch.from_numpy(cols.astype(np.int32)).to(cuda_device), sig)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(_ints(g), w, err_msg=name)
