"""siriltpu_torch.ops.cuda.reject_stack: the dispatcher's CPU route
against the JAX fused kernels (Pallas, interpret mode), and each CUDA
kernel against its plain version on the card.

The CUDA cases carry the ``cuda`` marker and skip without a card. They
need neither JAX nor siriltpu, so on a machine with a card and without
JAX they run with:

    PYTHONPATH=siril-0.9_tpu python -m pytest --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_reject_stack.py tests/test_torch_stacking.py
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
from siriltpu_torch.utils.build import KERNELS  # noqa: E402
from siriltpu_torch.utils.interop import frames_from_numpy  # noqa: E402
from siriltpu_torch.utils.timing import counters  # noqa: E402

PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "siril-0.9_tpu")


def make_vals(f: int, p: int, seed: int = 0, degen_every: int = 31) -> np.ndarray:
    """(F, P) uint16 with cold/hot outliers, real 65535 values and
    geomspace columns that end on the degenerate path."""
    rng = np.random.default_rng(500 + f + seed)
    vals = rng.integers(800, 1200, size=(f, p)).astype(np.uint16)
    vals[1, ::4] = 60000
    vals[min(3, f - 1), 2::7] = 0
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
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), "sigma", 2.5, 2.5,
                          with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)
    # the mean-only form returns the same mean
    np.testing.assert_array_equal(
        _ints(rs.reject_stack(frames_from_numpy(vals, "cpu"), "sigma", 2.5, 2.5)),
        _ints(got[0]))


#: (siglow, sighigh) per rejection; percentile takes (plow, phigh)
SIGS = {"sigma": (2.5, 2.5), "median": (0.0, 0.0), "percentile": (0.2, 0.1),
        "sigmedian": (3.0, 3.0), "winsorized": (2.5, 2.5)}


#: (rejection, F): the other four Pallas branches at F in {12, 25, 64};
#: percentile and sigmedian also at the borders of their register sorts of
#: 32, 64 and 128 wires (F <= 128) and at F = 3, the last F whose sigmedian
#: stops after one pass
FUSED_CASES = ([(r, f) for f in (12, 25, 64)
                for r in ("median", "percentile", "sigmedian", "winsorized")]
               + [(r, f) for f in (3, 33, 65, 129)
                  for r in ("percentile", "sigmedian")])


@pytest.mark.parametrize("rejection,F", FUSED_CASES)
def test_cpu_route_matches_pallas_interpret_fused(rejection, F):
    """The other four Pallas branches. The data needs fewer than 50 clip
    passes and fixed-point steps a pixel, so the Pallas pass cap of 50
    (the port's is 512) does not bind."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import reject_stack_pallas

    vals = make_vals(F, 256 if F <= 64 else 128)
    lo, hi = SIGS[rejection]
    want = reject_stack_pallas(jnp.asarray(vals), rejection, lo, hi,
                               tile=vals.shape[1], interpret=True,
                               with_counters=True)
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), rejection, lo, hi,
                          with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)


@pytest.mark.parametrize("F", [5, 12, 25, 64, 100])
def test_winsorized_window_matches_pallas_raw(F):
    """The plain winsorized window form, which carries its working copy as
    two clamp bounds a pixel, against the raw Pallas winsorized body,
    degenerate flags included (before any exact re-run). Fewer than 50
    passes and steps a pixel, as above."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import _reject_stack_raw

    vals = make_vals(F, 256)
    want = _reject_stack_raw(jnp.asarray(vals), "winsorized", 2.5, 2.5,
                             tile=256, interpret=True)
    mean, rejl, rejh, degen = trej.reject_winsorized_window(
        frames_from_numpy(vals, "cpu"), 2.5, 2.5)
    got = mean, degen, rejl, rejh
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)
    assert int(got[1].sum()) > 0, "the case must exercise degenerate pixels"


@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
@pytest.mark.parametrize("F", [1, 2, 3, 4])
def test_small_f_is_all_degenerate_then_exact(rejection, F):
    """For F <= 4 every pixel hits the reference's mid-scan break, so the
    window kernels flag all of them and the exact re-run decides each
    one: the dispatcher still equals reject_and_mean."""
    vals = frames_from_numpy(
        np.random.default_rng(F).integers(0, 65536, (F, 64)).astype(np.uint16),
        "cpu")
    _, degen, _, _ = rs.reject_plain(vals, rejection, 2.0, 2.0)
    assert bool(degen.all())
    got = rs.reject_stack(vals, rejection, 2.0, 2.0, with_counters=True)
    want = trej.reject_and_mean(vals, rejection, (2.0, 2.0))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)


def test_more_than_degen_k_degenerate_pixels():
    """The JAX wrapper re-runs at most DEGEN_K = 128 degenerate pixels per
    call and keeps the window result for the rest, so past 128 its fused
    output is not reject_and_mean's. The port re-runs every one of them:
    it is held to JAX reject_and_mean, the exact hybrid."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import DEGEN_K
    from siriltpu.ops.rejection import reject_and_mean

    vals = make_vals(25, 1024, seed=3, degen_every=3)
    _, degen, _, _ = rs.reject_plain(frames_from_numpy(vals, "cpu"), "sigma",
                                     2.5, 2.5)
    assert int(degen.sum()) > DEGEN_K
    want = reject_and_mean(jnp.asarray(vals), "sigma", (2.5, 2.5))
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), "sigma", 2.5, 2.5,
                          with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)


def test_more_than_degen_k_degenerate_pixels_winsorized():
    """The same for winsorized: every one of more than DEGEN_K degenerate
    pixels is re-run through the masked reject_winsorized, and the result
    is JAX reject_and_mean's."""
    import jax.numpy as jnp

    from siriltpu.ops.pallas.reject_stack import DEGEN_K
    from siriltpu.ops.rejection import reject_and_mean

    vals = make_vals(25, 512, seed=3, degen_every=3)
    _, degen, _, _ = rs.reject_plain(frames_from_numpy(vals, "cpu"),
                                     "winsorized", 2.5, 2.5)
    assert int(degen.sum()) > DEGEN_K
    want = reject_and_mean(jnp.asarray(vals), "winsorized", (2.5, 2.5))
    got = rs.reject_stack(frames_from_numpy(vals, "cpu"), "winsorized", 2.5,
                          2.5, with_counters=True)
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)


#: (F, P, geomspace column every, sig): F in {5, 12, 25, 100}, and one case
#: with more than DEGEN_K = 128 degenerate pixels
PLAIN_CASES = [(5, 256, 7, 1.5), (12, 256, 7, 2.5), (25, 256, 7, 2.5),
               (100, 256, 7, 3.0), (25, 768, 3, 2.5)]


@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
@pytest.mark.parametrize("F,P,every,sig", PLAIN_CASES)
def test_reject_plain_matches_jax_reject_and_mean(rejection, F, P, every, sig):
    """The plain version of the sigma and winsorized kernels (the window
    form, then the exact masked loop on its degenerate pixels) is JAX
    reject_and_mean's result, mean and both counters, and keeps the
    window form's degenerate flag."""
    import jax.numpy as jnp

    from siriltpu.ops.rejection import reject_and_mean

    vals = make_vals(F, P, degen_every=every)
    t = frames_from_numpy(vals, "cpu")
    mean, degen, rejl, rejh = rs.reject_plain(t, rejection, sig, sig)
    window = (trej.reject_sigma_window if rejection == "sigma"
              else trej.reject_winsorized_window)
    np.testing.assert_array_equal(_ints(degen), _ints(window(t, sig, sig)[3]))
    assert int(degen.sum()) > (128 if P > 256 else 0)
    want = reject_and_mean(jnp.asarray(vals), rejection, (sig, sig))
    for name, g, w in zip(("mean", "rejl", "rejh"), (mean, rejl, rejh), want):
        np.testing.assert_array_equal(_ints(g), np.asarray(w).astype(np.int32),
                                      err_msg=name)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        rs.reject_stack(torch.zeros((5, 8), dtype=torch.int32), "sigma", 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((5, 8, 2), dtype=torch.uint16), "sigma",
                        3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((0, 8), dtype=torch.uint16), "sigma", 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((5, 8), dtype=torch.uint16), "linearfit",
                        3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_cuda(torch.zeros((5, 8), dtype=torch.uint16), "sigma", 3.0, 3.0)


def test_port_imports_without_jax_or_siriltpu():
    """Every module of the port (the multi-device layer and its worker
    included) imports in a fresh interpreter without pulling in JAX or
    siriltpu (and without nvcc: the build is lazy), nor
    Pillow, imageio or matplotlib, which the image formats and the plots
    import only when a call needs them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import siriltpu_torch\n"
        "for m in pkgutil.walk_packages(siriltpu_torch.__path__, 'siriltpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'siriltpu')]\n"
        "assert not bad, bad\n"
        "for m in ('pipelines.register_stack', 'stacking.api', 'ops.stats',\n"
        "          'ops.stack', 'ops.shift', 'core.frame', 'core.memory',\n"
        "          'io.fits', 'io.ser', 'io.seqfile', 'io.sequence',\n"
        "          'registration.translation', 'registration.onestar',\n"
        "          'verify.oracle', 'ops.interp', 'ops.ecc', 'ops.wavelets',\n"
        "          'ops.psf', 'ops.photometry', 'ops.starfind', 'ops.warp',\n"
        "          'registration.matching', 'registration.ransac',\n"
        "          'registration.global_star', 'ops.imops', 'ops.demosaic',\n"
        "          'ops.cosmetic', 'ops.background', 'ops.histogram_ops',\n"
        "          'ops.display', 'parallel.engine', 'pipelines.preprocess',\n"
        "          'pipelines.full', 'ops.colors', 'ops.fftops', 'ops.wave_io',\n"
        "          'pipelines.compositing', 'pipelines.plots', 'io.formats',\n"
        "          'io.conversion', 'core.config', 'core.undo', 'cli.state',\n"
        "          'cli.commands', 'cli.main', 'parallel.mesh',\n"
        "          'parallel.sharded', 'parallel.multihost',\n"
        "          'parallel._mh_worker', 'parallel.dryrun'):\n"
        "    assert 'siriltpu_torch.' + m in sys.modules, m\n"
        "late = [k for k in sys.modules if k.split('.')[0] in\n"
        "        ('PIL', 'imageio', 'matplotlib')]\n"
        "assert not late, late\n")
    env = dict(os.environ, PYTHONPATH=PKG_ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rejection kernels run only on the card")
    return torch.device("cuda")


#: (rejection, F) cases on the card: every kernel at F in {2, ..., 1000};
#: sigma and winsorized also at the borders of their designs (sigma's
#: register sort of 32, 64 or 128 wires up to F = 128, winsorized's
#: 32-slot chunks and mask words); median, percentile and sigmedian at the
#: borders of their register sorts; and past the shared-memory bound (the
#: device-memory scratch path)
CASE_FS = (2, 3, 5, 12, 25, 64, 100, 256, 1000)
BORDER_FS = (63, 65, 127, 128, 129, 511, 512, 1024, 1025)
WIRE_BORDER_FS = (31, 32, 33, 63, 64, 65, 127, 128, 129)
CUDA_CASES = ([(r, f) for r in KERNELS for f in CASE_FS]
              + [(r, f) for r in ("sigma", "winsorized") for f in BORDER_FS]
              + [(r, f) for r in ("median", "percentile", "sigmedian")
                 for f in WIRE_BORDER_FS if f not in CASE_FS]
              + [(r, 4000) for r in ("sigma", "median", "percentile", "sigmedian")]
              + [("winsorized", 2000)])


def launched(kernel: str) -> int:
    """The kernel's launches counted so far in this process."""
    return counters().get(f"reject.launches.{kernel}", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rejection,F", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, monkeypatch, rejection, F):
    p = 8192 + 77 if F <= 1025 else 1024 + 77
    vals = frames_from_numpy(make_vals(F, p) if F >= 4 else
                             np.random.default_rng(F).integers(
                                 0, 65536, (F, p)).astype(np.uint16), cuda_device)
    lo, hi = SIGS[rejection]
    scratch = F > 1025
    if scratch:
        # winsorized at F = 2000 fits in shared memory: no shared memory
        # at all sends it to the scratch path
        if rejection == "winsorized":
            monkeypatch.setattr(rs, "SMEM_LIMIT", 0)
        # 256 pixels a launch: the scratch path runs in five launches
        monkeypatch.setattr(rs, "SCRATCH_BYTES",
                            rs.launch_plan(rejection, F, 256).scratch_bytes)
    plan = rs.launch_plan(rejection, F, p)
    assert plan.scratch == scratch
    assert plan.chunk == (256 if scratch else p)
    before = launched(rejection)
    got = rs.reject_cuda(vals, rejection, lo, hi)
    torch.cuda.synchronize()
    assert launched(rejection) == before + (5 if scratch else 1)
    want = rs.reject_plain(vals, rejection, lo, hi)
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)


@pytest.mark.cuda
def test_cuda_launch_plan(cuda_device):
    """The tiles the C plans choose, the shared memory of the register
    sorts, where the scratch path begins, and the winsorized kernel's
    occupancy at F = 1000."""
    def tile(rejection, f):
        plan = rs.launch_plan(rejection, f)
        return None if plan.scratch else plan.tile

    assert tile("sigma", 100) == 128
    # the median and percentile run their whole bodies in registers up to
    # F = 128: no shared memory; sigmedian writes its sorted column there, a
    # thread at stride tile + 2
    for rejection in ("median", "percentile"):
        for f in (50, 128):
            plan = rs.launch_plan(rejection, f)
            assert (plan.tile, plan.smem, plan.scratch) == (128, 0, False)
        assert rs.launch_plan(rejection, 129).smem == 129 * 128 * 2
    assert rs.launch_plan("sigmedian", 50).smem == 50 * 130 * 2
    assert tile("sigma", 1000) == 64
    # winsorized: a warp a pixel, 8 pixels a block while they fit
    assert tile("winsorized", 1000) == 8
    assert tile("winsorized", 14000) == 4
    # past the shared-memory bound the kernels run on a device-memory
    # scratch copy: no F is refused
    assert tile("sigma", 3399) == 32
    assert tile("sigma", 3400) is None
    assert tile("median", 3632) == 32
    assert tile("median", 3633) is None
    assert tile("winsorized", 97000) == 1
    assert tile("winsorized", 98000) is None
    assert rs.launch_plan("winsorized", 1000).warps >= 16


@pytest.mark.cuda
@pytest.mark.parametrize("rejection", KERNELS)
def test_cuda_wrapper_matches_reject_and_mean(cuda_device, rejection):
    vals = frames_from_numpy(make_vals(25, 4096, degen_every=3), cuda_device)
    lo, hi = SIGS[rejection]
    before = launched(rejection)
    # the CUDA route makes no host sync, degenerate pixels included
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rs.reject_stack(vals, rejection, lo, hi, with_counters=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert launched(rejection) == before + 1
    if rejection == "median":
        np.testing.assert_array_equal(_ints(got[0]),
                                      _ints(trej.masked_median(vals)))
        return
    want = trej.reject_and_mean(vals, rejection, (lo, hi))
    for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [3, 50, 128])
@pytest.mark.parametrize("flags", ["all", "none"])
def test_cuda_sigmedian_first_pass_exits(cuda_device, flags, F):
    """Both ends of the sigmedian clip's first pass on the register sort:
    negative sigmas flag every value of every column (nlow + nhigh >= F:
    the whole column becomes the replacement), and sigmas of 50 flag none
    (the first pass is the last)."""
    sig = -1.0 if flags == "all" else 50.0
    vals = frames_from_numpy(make_vals(F, 4096), cuda_device)
    got = rs.reject_cuda(vals, "sigmedian", sig, sig)
    torch.cuda.synchronize()
    want = rs.reject_plain(vals, "sigmedian", sig, sig)
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)
    nflag = _ints(got[2]) + _ints(got[3])
    if flags == "all":
        assert (nflag >= F).all()
    else:
        assert (nflag == 0).all()
