"""The float64 settle of linear-fit clipping
(``siriltpu_torch.ops.rejection.linearfit_settle``) against the compiled
reference C (tests/goldens/c_rejection.bin) and the literal per-pixel
oracle (``verify.oracle.c_reject_block``), at tolerance 0 on the mean and
both counters; on the card, the linear-fit kernel
(``ops/cuda/reject_stack.py:linearfit_cuda``) against both, in each of
its forms.

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

from siriltpu_torch.ops.cuda import reject_stack as rs  # noqa: E402
from siriltpu_torch.ops.rejection import (linearfit_exact,  # noqa: E402
                                          linearfit_settle)
from siriltpu_torch.utils.timing import counters  # noqa: E402
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
    groups = _records(n)
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


def _records(n: int) -> dict:
    """The compiled C's linearfit records with n values, by sig: lists of
    (vec, mean, rejl, rejh)."""
    groups = {}
    for kind, _, nn, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == "linearfit" and nn == n:
            groups.setdefault((sig0, sig1), []).append((vec, mean, rej0, rej1))
    return groups


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 8, 16, 33, 64, 128])
def test_cuda_kernel_matches_compiled_c(cuda_device, n):
    """The linear-fit kernel on every linearfit record of the compiled C
    with n values: the mean and both counters at tolerance 0."""
    groups = _records(n)
    assert sum(len(v) for v in groups.values()) == 72
    for sig, items in groups.items():
        cols = np.stack([it[0] for it in items], axis=1).astype(np.uint16)
        vals = torch.from_numpy(cols.view(np.int16)).view(torch.uint16).to(cuda_device)
        got = rs.linearfit_cuda(vals, *sig)
        for col, name, g in zip((1, 2, 3), ("mean", "rejl", "rejh"), got):
            want = [it[col] for it in items]
            np.testing.assert_array_equal(_ints(g), want, err_msg=f"{name} sig={sig}")


#: F across the kernel's forms: the wires form's 2H = 4 .. 64 wires (F = 1
#: to 64) and its end, the shared form past it with one to ten mask words
KERNEL_FS = (1, 2, 3, 4, 5, 8, 50, 63, 64, 65, 100, 128, 129, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["smem", "scratch"])
@pytest.mark.parametrize("F", KERNEL_FS)
def test_cuda_kernel_matches_settle(cuda_device, monkeypatch, F, where):
    """The linear-fit kernel against ``linearfit_settle`` on every column,
    at both sigs, in the form its plan takes at F (wires up to 64, shared
    past it) and, with no shared memory, in the scratch form; each call is
    one launch of that form."""
    if where == "scratch":
        monkeypatch.setattr(rs, "SMEM_LIMIT", 0)
    cols = np.tile(settle_columns(F, seed=40), (1, 3))
    p = cols.shape[1]
    form = "scratch" if where == "scratch" else "wires" if F <= 64 else "shared"
    plan = rs.launch_plan("linearfit", F, p)
    assert (plan.form, plan.chunk, plan.scratch) == (form, p, where == "scratch")
    vals = torch.from_numpy(cols.view(np.int16)).view(torch.uint16)
    for sig in SIGS:
        key = f"reject.form.linearfit.{form}"
        before = counters().get(key, 0)
        got = rs.linearfit_cuda(vals.to(cuda_device), *sig)
        assert counters()[key] == before + 1
        want = linearfit_settle(vals, sig)
        for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
            np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=f"{name} sig={sig}")


#: F whose blocks span more pixels than they have lanes at REFILL_P: the
#: wires form (50, more than its ring's two halves of 64 columns) and the
#: shared form (65, 100, 300; at most 128 lanes a block)
REFILL_FS = (50, 65, 100, 300)
REFILL_P = 1 << 18


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["smem", "scratch"])
@pytest.mark.parametrize("F", REFILL_FS)
def test_cuda_kernel_refills_its_lanes(cuda_device, monkeypatch, F, where):
    """At P = 2^18 every block's span is longer than its lanes, so lanes
    take second and later pixels: the wires form stages more halves of its
    ring than it has and reuses them, and the memory forms copy and sort a
    new column into a lane's slot and start its state afresh. The kernel
    against ``linearfit_settle`` on the card on every column, at both sigs;
    the columns are the settle's cases drawn at random, half of them with
    a little noise added, so that neighbouring pixels end after different
    passes."""
    if where == "scratch":
        monkeypatch.setattr(rs, "SMEM_LIMIT", 0)
    rng = np.random.default_rng(F)
    base = settle_columns(F, seed=50).astype(np.int64)
    cols = base[:, rng.integers(0, base.shape[1], REFILL_P)]
    noisy = rng.random(REFILL_P) < 0.5
    cols[:, noisy] += rng.integers(-3, 4, size=(F, int(noisy.sum())))
    cols = np.ascontiguousarray(cols.clip(0, 65535).astype(np.uint16))
    form = "scratch" if where == "scratch" else "wires" if F <= 64 else "shared"
    plan = rs.launch_plan("linearfit", F, REFILL_P)
    assert (plan.form, plan.chunk, plan.scratch) == (form, REFILL_P, where == "scratch")
    assert plan.tile > (2 * 64 if form == "wires" else 128), plan.tile
    vals = torch.from_numpy(cols.view(np.int16)).view(torch.uint16).to(cuda_device)
    for sig in SIGS:
        key = f"reject.form.linearfit.{form}"
        before = counters().get(key, 0)
        got = rs.linearfit_cuda(vals, *sig)
        assert counters()[key] == before + 1
        want = linearfit_settle(vals, sig)
        for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
            np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=f"{name} sig={sig}")
