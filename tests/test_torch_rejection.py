"""siriltpu_torch.ops.rejection against siriltpu.ops.rejection and the
compiled reference C (tests/goldens/c_rejection.bin).

Both packages get the same seeded NumPy inputs; every comparison is
bit-exact (means, counters, masks and degenerate flags), because the
port computes every statistic with the same integer sums and the same
float32 operations in the same order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.ops import rejection as jrej  # noqa: E402
from siriltpu_torch.ops import rejection as trej  # noqa: E402
from siriltpu_torch.ops.cuda.reject_stack import reject_stack  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy  # noqa: E402

from test_c_goldens import REJ_NAMES, _read_rejection  # noqa: E402

P = 384


def make_vals(f: int, p: int = P, seed: int = 0) -> np.ndarray:
    """(F, P) uint16: noise around 1000 with cold (0) and hot (60000)
    outliers, real 65535 values, and geomspace columns that keep
    clipping until the reference's mid-scan break (degenerate pixels)."""
    rng = np.random.default_rng(1000 + 7 * f + seed)
    vals = rng.integers(900, 1100, size=(f, p)).astype(np.uint16)
    vals[1 % f, ::4] = 60000
    vals[3 % f, 2::7] = 0
    vals[: min(2, f), ::11] = 65535
    for c in range(5, p, 23):
        vals[:, c] = np.geomspace(1, 65535, f).astype(np.uint16)
    return vals


def t(x: np.ndarray):
    return frames_from_numpy(x, "cpu")


@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_reject_sigma_window_matches_jax(F):
    vals = make_vals(F)
    # with 5 values no sample lies beyond 4/sqrt(5) sd: clip at 1.5 there
    sig = 1.5 if F < 10 else 2.5
    want = jrej.reject_sigma_window(jnp.asarray(vals), sig, sig)
    got = trej.reject_sigma_window(t(vals), sig, sig)
    for name, g, w in zip(("mean", "rejl", "rejh", "degen"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32),
            err_msg=name)
    assert bool(got[3].any()), "the case must exercise degenerate pixels"


@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_reject_sigma_masked_active_matches_jax(F):
    vals = make_vals(F, seed=1)
    active = np.random.default_rng(F).random(P) < 0.5
    want = jrej.reject_sigma(jnp.asarray(vals, jnp.float32), 2.5, 2.5,
                             active=jnp.asarray(active))
    got = trej.reject_sigma(t(vals), 2.5, 2.5, active=torch.from_numpy(active))
    for name, g, w in zip(("valid", "sorted", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("rejection", ["sigma", "sigma_masked"])
@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_reject_and_mean_matches_jax(rejection, F):
    vals = make_vals(F, seed=2)
    want = jrej.reject_and_mean(jnp.asarray(vals), rejection, (3.0, 2.0))
    got = trej.reject_and_mean(t(vals), rejection, (3.0, 2.0))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32),
            err_msg=name)


def _golden_groups():
    groups = {}
    for kind, _, n, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == "sigma_masked":
            groups.setdefault((n, sig0, sig1), []).append((vec, mean, rej0, rej1))
    return groups


@pytest.mark.parametrize("route", ["sigma", "sigma_masked", "reject_stack"])
def test_sigma_goldens_exact(route):
    """Every sigma record of the compiled C, mean and both counters, per
    record, through the hybrid, the masked loop, and the kernel wrapper's
    CPU route."""
    groups = _golden_groups()
    assert sum(len(v) for v in groups.values()) == 432
    for (n, sig0, sig1), items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1)  # (n, records)
        if route == "reject_stack":
            mean, rl, rh = reject_stack(t(vals), "sigma", sig0, sig1,
                                        with_counters=True)
        else:
            mean, rl, rh = trej.reject_and_mean(
                torch.from_numpy(vals.astype(np.float32)), route, (sig0, sig1))
        ctx = f"n={n} sig=({sig0}, {sig1})"
        np.testing.assert_array_equal(mean.to(torch.int32).numpy(),
                                      [it[1] for it in items], err_msg=ctx)
        np.testing.assert_array_equal(rl.numpy(), [it[2] for it in items],
                                      err_msg=ctx)
        np.testing.assert_array_equal(rh.numpy(), [it[3] for it in items],
                                      err_msg=ctx)


@pytest.mark.parametrize("rejection", ["none", "percentile", "sigmedian",
                                       "winsorized", "linearfit"])
def test_unported_rejections_raise(rejection):
    """Every rejection, once unported, now equals JAX reject_and_mean
    (linearfit on this block, which holds no knife-edge pixel; see
    test_torch_linearfit.py)."""
    vals = make_vals(8, p=16)
    want = jrej.reject_and_mean(jnp.asarray(vals), rejection, (2.0, 2.0))
    got = trej.reject_and_mean(t(vals), rejection, (2.0, 2.0))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32),
            err_msg=name)


#: (siglow, sighigh) per rejection; percentile takes (plow, phigh)
SIGS = {"none": (3.0, 3.0), "percentile": (0.2, 0.1),
        "sigmedian": (2.5, 2.5), "winsorized": (2.5, 2.0)}


@pytest.mark.parametrize("F", [2, 3, 4, 5, 12, 25, 64])
@pytest.mark.parametrize("rejection", ["none", "percentile", "sigmedian",
                                       "winsorized"])
def test_reject_and_mean_fused_rejections_match_jax(rejection, F):
    vals = make_vals(F, p=256, seed=4)
    want = jrej.reject_and_mean(jnp.asarray(vals), rejection, SIGS[rejection])
    got = trej.reject_and_mean(t(vals), rejection, SIGS[rejection])
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32),
            err_msg=name)


def test_winsorized_many_frames_matches_jax():
    vals = make_vals(1000, p=24, seed=5)
    want = jrej.reject_and_mean(jnp.asarray(vals), "winsorized", (3.0, 3.0))
    got = trej.reject_and_mean(t(vals), "winsorized", (3.0, 3.0))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32),
            err_msg=name)


@pytest.mark.parametrize("F", [2, 3, 4, 5, 12, 25, 64])
def test_masked_median_matches_jax(F):
    vals = make_vals(F, p=256, seed=6)
    want = jrej.masked_median(jnp.asarray(vals, jnp.float32))
    got = trej.masked_median(t(vals))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.to(torch.int32).numpy(),
                                  np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("rejection", ["none", "percentile", "sigmedian",
                                       "winsorized"])
def test_fused_rejection_goldens_exact(rejection):
    """Every record of the compiled C for this rejection, mean and both
    counters, through reject_and_mean and the dispatcher's CPU route
    (none through its plain route there)."""
    groups = {}
    for kind, _, n, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == rejection:
            groups.setdefault((n, sig0, sig1), []).append((vec, mean, rej0, rej1))
    assert groups
    for (n, sig0, sig1), items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1)  # (n, records)
        for route in ("reject_and_mean", "reject_stack"):
            if route == "reject_stack":
                mean, rl, rh = reject_stack(t(vals), rejection, sig0, sig1,
                                            with_counters=True)
            else:
                mean, rl, rh = trej.reject_and_mean(t(vals), rejection,
                                                    (sig0, sig1))
            ctx = f"{route} n={n} sig=({sig0}, {sig1})"
            np.testing.assert_array_equal(mean.to(torch.int32).numpy(),
                                          [it[1] for it in items], err_msg=ctx)
            np.testing.assert_array_equal(rl.numpy(), [it[2] for it in items],
                                          err_msg=ctx)
            np.testing.assert_array_equal(rh.numpy(), [it[3] for it in items],
                                          err_msg=ctx)
