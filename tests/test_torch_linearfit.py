"""Linear-fit clipping of siriltpu_torch against siriltpu and the compiled
reference C (tests/goldens/c_rejection.bin).

Both packages get the same seeded NumPy inputs. Tolerances:

- the hybrid (f32 fit, then the f64 oracle on the knife-edge pixels) is
  held at tolerance 0 on the mean and both counters, on seeded blocks and
  on every linearfit record of the compiled C;
- the plain f32 fit is held at tolerance 0 (survivor mask, sorted values,
  counters, mean) on every pixel that neither package flags ``knife``;
- the knife masks themselves only loosely: the fit's sums over F are f32
  reductions whose order torch and XLA do not share, so a ratio that lies
  within ~1e-5 of the 1e-4 band's edge may be flagged by one package and
  not by the other. At most 1 pixel in 100 may differ (on this file's
  blocks none does; 1 in 2048 did on a wider block of the same kind)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from siriltpu.ops import rejection as jrej  # noqa: E402
from siriltpu.verify import oracle as joracle  # noqa: E402
from siriltpu_torch.ops import rejection as trej  # noqa: E402
from siriltpu_torch.verify import oracle as toracle  # noqa: E402

from test_c_goldens import REJ_NAMES, _read_rejection  # noqa: E402
from test_torch_rejection import make_vals  # noqa: E402

P = 1024
SIGS = [(3.0, 3.0), (2.0, 1.5)]


def make_block(f: int, seed: int) -> np.ndarray:
    """``make_vals`` with every third column replaced by continuous noise,
    so that the block holds pixels that clip little, pixels that clip to
    the reference's mid-scan break, and a few knife-edge ones."""
    vals = make_vals(f, p=P, seed=seed)
    rng = np.random.default_rng(f + seed)
    noise = rng.normal(1000, 30, size=vals[:, 1::3].shape)
    vals[:, 1::3] = noise.clip(0, 65535).astype(np.uint16)
    return vals


def f32(vals: np.ndarray):
    return torch.from_numpy(vals.astype(np.float32))


@pytest.mark.parametrize("sig", SIGS)
@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_reject_linearfit_matches_jax(F, sig):
    vals = make_block(F, seed=3)
    want = [np.asarray(x) for x in
            jrej.reject_linearfit(jnp.asarray(vals, jnp.float32), *sig)]
    got = [x.numpy() for x in trej.reject_linearfit(f32(vals), *sig)]
    either = want[4] | got[4]
    assert (want[4] != got[4]).sum() <= P // 100, "knife masks"
    np.testing.assert_array_equal(got[1], want[1], err_msg="sorted values")
    np.testing.assert_array_equal(got[0][:, ~either], want[0][:, ~either],
                                  err_msg="survivors")
    for name, g, w in zip(("rejl", "rejh"), got[2:4], want[2:4]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g[~either], w[~either], err_msg=name)
    if sig == SIGS[1]:
        assert got[4].any() and got[2].any() and got[3].any(), \
            "the case must exercise both clips and the knife flag"


@pytest.mark.parametrize("sig", SIGS)
@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_linearfit_hybrid_matches_jax(F, sig):
    vals = make_block(F, seed=4)
    want = jrej.linearfit_hybrid_block(vals, sig)
    got = trej.linearfit_hybrid_block(vals, sig, device="cpu")
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_linearfit_hybrid_takes_a_uint16_tensor():
    vals = make_block(12, seed=5)
    a = trej.linearfit_hybrid_block(vals, (2.0, 1.5), device="cpu")
    b = trej.linearfit_hybrid_block(
        torch.from_numpy(vals.view(np.int16)).view(torch.uint16), (2.0, 1.5),
        device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("F", [5, 12, 25, 100])
def test_reject_and_mean_linearfit_matches_jax(F):
    """The plain f32 result, without the exact re-run, as in the JAX
    package: tolerance 0 off the knife-edge pixels."""
    vals = make_block(F, seed=6)
    knife = (np.asarray(jrej.reject_linearfit(
        jnp.asarray(vals, jnp.float32), 2.0, 1.5)[4])
        | trej.reject_linearfit(f32(vals), 2.0, 1.5)[4].numpy())
    want = jrej.reject_and_mean(jnp.asarray(vals), "linearfit", (2.0, 1.5))
    got = trej.reject_and_mean(
        torch.from_numpy(vals.view(np.int16)).view(torch.uint16), "linearfit",
        (2.0, 1.5))
    assert got[0].dtype == torch.uint16
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(
            g.to(torch.int32).numpy()[~knife],
            np.asarray(w).astype(np.int32)[~knife], err_msg=name)


@pytest.mark.parametrize("n", [5, 8, 16, 33, 64, 128])
def test_linearfit_goldens_exact(n):
    """Every linearfit record of the compiled C with n values, mean and
    both counters at tolerance 0 through the hybrid, as
    tests/test_c_goldens.py holds the JAX package."""
    groups = {}
    for kind, _, nn, sig0, sig1, vec, mean, rej0, rej1 in _read_rejection():
        if REJ_NAMES[kind] == "linearfit" and nn == n:
            groups.setdefault((sig0, sig1), []).append((vec, mean, rej0, rej1))
    assert sum(len(v) for v in groups.values()) == 72
    for sig, items in groups.items():
        vals = np.stack([it[0] for it in items], axis=1)
        mean, rl, rh = trej.linearfit_hybrid_block(vals, sig, device="cpu")
        for name, g, col in (("mean", mean, 1), ("rejl", rl, 2), ("rejh", rh, 3)):
            np.testing.assert_array_equal(g, [it[col] for it in items],
                                          err_msg=f"{name} sig={sig}")


@pytest.mark.parametrize("rejection", ["none", "percentile", "sigma",
                                       "sigmedian", "winsorized", "linearfit"])
def test_oracle_reject_block_matches_siriltpu(rejection):
    """The port's copy of the per-pixel oracle against the JAX package's:
    survivors and counters, on vectors that clip down to the break."""
    rng = np.random.default_rng(11)
    sig = (0.2, 0.1) if rejection == "percentile" else (2.0, 1.5)
    for n in (1, 2, 4, 5, 9, 30, 64):
        for vec in (rng.integers(900, 1100, n), rng.integers(0, 65536, n),
                    np.geomspace(1, 65535, n), np.full(n, 777)):
            vec = np.asarray(vec).astype(np.uint16)
            want = joracle.c_reject_block(vec, rejection, sig)
            got = toracle.c_reject_block(vec, rejection, sig)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def test_oracle_rejects_unknown_rejection():
    with pytest.raises(ValueError):
        toracle.c_reject_block(np.arange(5), "nope", (3, 3))


@pytest.mark.parametrize("mode", ["none", "additive", "additive_scaling",
                                  "multiplicative", "multiplicative_scaling"])
def test_oracle_normalize_pixel_vector_matches_siriltpu(mode):
    pix = np.random.default_rng(12).integers(0, 65536, 64).astype(np.uint16)
    args = (mode, 1.0173, 41.37, 0.9821)
    np.testing.assert_array_equal(toracle.normalize_pixel_vector(pix, *args),
                                  joracle.normalize_pixel_vector(pix, *args))
