"""siriltpu_torch.ops.cuda.reject_stack: the wrapper's CPU route against
the JAX fused kernel (Pallas, interpret mode), and the CUDA kernel against
its plain version on the card.

The CUDA cases carry the ``cuda`` marker and skip without a card. They
need neither JAX nor siriltpu, so on a machine with a card and without
JAX they run with:

    PYTHONPATH=siril-0.9_tpu python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_reject_stack.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.ops import rejection as trej  # noqa: E402
from siriltpu_torch.ops.cuda import reject_stack as rs  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy  # noqa: E402

PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "siril-0.9_tpu")


def make_vals(f: int, p: int, seed: int = 0, degen_every: int = 31) -> np.ndarray:
    """(F, P) uint16 with cold/hot outliers, real 65535 values and
    geomspace columns that end on the degenerate path."""
    rng = np.random.default_rng(500 + f + seed)
    vals = rng.integers(800, 1200, size=(f, p)).astype(np.uint16)
    vals[1, ::4] = 60000
    vals[3, 2::7] = 0
    vals[:2, ::11] = 65535
    for c in range(0, p, degen_every):
        vals[:, c] = np.geomspace(1, 65535, f).astype(np.uint16)
    return vals


def _ints(x):
    return x.cpu().to(torch.int32).numpy()


@pytest.mark.parametrize("F", [12, 25, 100])
def test_cpu_route_matches_pallas_interpret(F):
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import reject_stack_pallas

    vals = make_vals(F, 256)
    want = reject_stack_pallas(jnp.asarray(vals), "sigma", 2.5, 2.5, tile=256,
                               interpret=True, with_counters=True)
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), 2.5, 2.5,
                          with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)
    # the mean-only form returns the same mean
    np.testing.assert_array_equal(
        _ints(rs.reject_stack(frames_from_numpy(vals, "cpu"), 2.5, 2.5)),
        _ints(got[0]))


def test_more_than_degen_k_degenerate_pixels():
    """The JAX wrapper re-runs at most DEGEN_K = 128 degenerate pixels per
    call and keeps the window result for the rest, so past 128 its fused
    output is not reject_and_mean's. The port re-runs every one of them:
    it is held to JAX reject_and_mean, the exact hybrid."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import DEGEN_K
    from siriltpu.ops.rejection import reject_and_mean

    vals = make_vals(25, 1024, seed=3, degen_every=3)
    _, degen, _, _ = rs.reject_sigma_plain(frames_from_numpy(vals, "cpu"),
                                           2.5, 2.5)
    assert int(degen.sum()) > DEGEN_K
    want = reject_and_mean(jnp.asarray(vals), "sigma", (2.5, 2.5))
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), 2.5, 2.5,
                          with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        rs.reject_stack(torch.zeros((5, 8), dtype=torch.int32), 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((5, 8, 2), dtype=torch.uint16), 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((0, 8), dtype=torch.uint16), 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_sigma_cuda(torch.zeros((5, 8), dtype=torch.uint16), 3.0, 3.0)
    assert rs.pick_tile(100) == 128
    assert rs.pick_tile(1000) == 64
    with pytest.raises(ValueError):
        rs.pick_tile(4000)


def test_port_imports_without_jax_or_siriltpu():
    """Every module of the port imports in a fresh interpreter without
    pulling in JAX or siriltpu (and without nvcc: the build is lazy)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import siriltpu_torch\n"
        "for m in pkgutil.walk_packages(siriltpu_torch.__path__, 'siriltpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'siriltpu')]\n"
        "assert not bad, bad\n"
        "assert 'siriltpu_torch.pipelines.register_stack' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=PKG_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sigma kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("F", [5, 7, 12, 25, 64, 100, 256, 1000])
def test_cuda_kernel_matches_plain(cuda_device, F):
    vals = frames_from_numpy(make_vals(F, 8192 + 77), cuda_device)
    got = rs.reject_sigma_cuda(vals, 2.5, 2.5)
    torch.cuda.synchronize()
    want = rs.reject_sigma_plain(vals, 2.5, 2.5)
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)


@pytest.mark.cuda
def test_cuda_wrapper_matches_reject_and_mean(cuda_device):
    vals = frames_from_numpy(make_vals(25, 4096, degen_every=3), cuda_device)
    before = rs.launches
    got = rs.reject_stack(vals, 2.5, 2.5, with_counters=True)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    want = trej.reject_and_mean(vals, "sigma", (2.5, 2.5))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)
