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
from siriltpu_torch.utils import timing  # noqa: E402
from siriltpu_torch.utils.timing import counters  # noqa: E402
from siriltpu_torch.verify import oracle  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "siril-0.9_tpu")


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


#: A column of 100 values built so that the sd's anchor decides a sigma
#: (3, 3) clip. About the upper middle value 1001 its deviations sum to 451
#: and their squares to 51413: 100 * 51413 - 451**2 = 67**2 * 1100 - 1, so
#: the exact 3 sd lies just under 67, the gap of the maximum 1067 above the
#: median 1000. The one float32 combine reads 3 sd as 67.0 about the lower
#: middle value 999 (1067 kept, mean 1006) and under 67 about the upper one
#: (1067 rejected high, mean 1005, as Siril's float64 loop has it).
ANCHOR_SPLIT = np.array([
    955, 965, 969, 972, 973, 975, 975, 976, 977, 978, 979, 980,
    981, 982, 982, 984, 984, 986, 986, 986, 987, 988, 989, 989,
    990, 990, 991, 991, 991, 992, 994, 994, 994, 995, 996, 996,
    997, 997, 997, 998, 999, 999, 999, 999, 999, 999, 999, 999,
    999, 999, 1001, 1002, 1004, 1006, 1006, 1006, 1007, 1007, 1008, 1008,
    1008, 1008, 1011, 1011, 1012, 1014, 1014, 1014, 1016, 1016, 1016, 1017,
    1017, 1019, 1019, 1021, 1021, 1021, 1021, 1023, 1023, 1024, 1024, 1026,
    1026, 1032, 1033, 1037, 1038, 1039, 1040, 1040, 1040, 1041, 1042, 1046,
    1049, 1058, 1061, 1067], dtype=np.uint16)

#: The 100 words that enter the sigma kernel at pixel 13397834 (row 3270,
#: column 3914) of seed 3100000309 of the benchmark cell
#: deepsky_mono_4k.resident, as the card aligned them. 1078 lies 77 above
#: the median 1001, against 3 sd = 3 x 25.6667: about the lower middle
#: value the kernel kept it (1007), about the upper one it is rejected
#: high (1006), as in the masked loop and Siril's float64 loop.
KNIFE_EDGE = np.array([
    997, 995, 982, 1047, 997, 1009, 995, 1017, 1033, 988, 1020, 991,
    1009, 993, 974, 1032, 980, 985, 979, 1021, 975, 980, 1056, 1054,
    1009, 1026, 1053, 1006, 978, 977, 1023, 1038, 1019, 978, 999, 1015,
    970, 979, 994, 1017, 975, 997, 1043, 1003, 1051, 982, 1020, 1017,
    1044, 970, 1078, 987, 1004, 960, 1018, 1000, 1018, 964, 993, 1015,
    1002, 1009, 1022, 1045, 1048, 972, 969, 1000, 987, 998, 1041, 990,
    1012, 1030, 985, 1031, 984, 1027, 1038, 1049, 1015, 1047, 992, 1000,
    993, 1053, 991, 992, 1016, 976, 1020, 976, 1006, 995, 983, 1049,
    989, 1006, 993, 991], dtype=np.uint16)

#: sigma (3, 3) columns on which the two middle values give the sd's
#: anchor different clips: (column, mean, rejected low, rejected high),
#: as the masked loop and Siril's loop decide them; in each the largest
#: value is the one rejected high, and no pixel is degenerate
ANCHOR_CASES = {"built": (ANCHOR_SPLIT, 1005, 0, 1),
                "deepsky_3100000309": (KNIFE_EDGE, 1006, 0, 1)}


def anchor_vals(case: str, device) -> torch.Tensor:
    """The case's column in 40 pixels, each in its own order."""
    col = ANCHOR_CASES[case][0]
    rng = np.random.default_rng(40)
    return frames_from_numpy(
        np.stack([rng.permutation(col) for _ in range(40)], axis=1), device)


def test_built_column_separates_the_two_anchors():
    """The built column's first pass: 3 sd about the lower middle value is
    67.0, which 1067 does not pass; about the upper one it is less."""
    x = torch.from_numpy(ANCHOR_SPLIT.astype(np.int32))[:, None]
    n = torch.tensor([100], dtype=torch.int32)
    gap = torch.tensor(1067.0) - 0.5 * torch.tensor(999.0 + 1001.0)
    three = torch.tensor(3.0)
    lower = three * trej._sd_of_deviations(x - 999, n)[0]
    upper = three * trej._sd_of_deviations(x - 1001, n)[0]
    assert float(lower) == 67.0 and not bool(gap > lower)
    assert bool(gap > upper)


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_sigma_anchor_cases(case):
    """The window form anchors its sd on the upper middle value, as
    ``_gsl_sd`` does: on these columns the plain kernel, the window form
    and the masked loop give Siril's clips and mean, with no pixel left
    to the exact re-run."""
    col, mean, rejl, rejh = ANCHOR_CASES[case]
    vals = anchor_vals(case, "cpu")
    want = {"mean": mean, "degen": 0, "rejl": rejl, "rejh": rejh}
    plain = dict(zip(("mean", "degen", "rejl", "rejh"),
                     rs.reject_plain(vals, "sigma", 3.0, 3.0)))
    window = dict(zip(("mean", "rejl", "rejh", "degen"),
                      trej.reject_sigma_window(vals, 3.0, 3.0)))
    masked = dict(zip(("mean", "rejl", "rejh"),
                      trej.reject_and_mean(vals, "sigma_masked", (3.0, 3.0))))
    for form, got in (("plain", plain), ("window", window), ("masked", masked)):
        for name, g in got.items():
            assert (_ints(g) == want[name]).all(), (form, name)
    surv = oracle.reject_pixel(col, "sigma", (3.0, 3.0))
    assert len(surv) == len(col) - rejl - rejh
    assert int(surv.max()) < int(col.max())
    assert int(np.floor(int(surv.astype(np.int64).sum()) / len(surv) + 0.5)) == mean


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


@pytest.mark.parametrize("rejection", KERNELS + ("none", "sigma_masked",
                                                 "linearfit"))
def test_cpu_route_span_reports_form_plain(rejection):
    """On the CPU route the ``stack.reject`` span names the form
    ``plain``, and no kernel form is counted (``reject.form.*`` counts
    launches on the card only). A rejection without a kernel takes the
    same span and gives ``reject_and_mean``'s words and counters."""
    vals = frames_from_numpy(make_vals(25, 64), "cpu")
    lo, hi = SIGS.get(rejection, (2.5, 2.5))

    def forms():
        return {k: v for k, v in counters().items() if k.startswith("reject.form.")}

    before = forms()
    timing.collect()
    timing.enable()
    try:
        got = rs.reject_stack(vals, rejection, lo, hi, with_counters=True)
    finally:
        timing.disable()
    spans = [s for s in timing.collect() if s.name == "stack.reject"]
    assert [s.attrs for s in spans] == [
        {"shape": (25, 64), "rejection": rejection, "form": "plain"}]
    assert forms() == before
    if rejection not in KERNELS:
        want = trej.reject_and_mean(vals, rejection, (lo, hi))
        for name, g, w in zip(("mean", "rejl", "rejh"), got, want):
            np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        rs.reject_stack(torch.zeros((5, 8), dtype=torch.int32), "sigma", 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((5, 8, 2), dtype=torch.uint16), "sigma",
                        3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((0, 8), dtype=torch.uint16), "sigma", 3.0, 3.0)
    with pytest.raises(ValueError):
        rs.reject_stack(torch.zeros((5, 8), dtype=torch.uint16), "kappa",
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
#: sigma and winsorized also at the borders of their designs (sigma's team
#: form up to F = 128, winsorized's 32-slot chunks and mask words); sigma,
#: median, percentile and sigmedian at the borders of the register sorts
#: of 32, 64 or 128 wires, and sigma at every F where its team form's
#: lanes a pixel (T) or registers a lane (H) change; and past the
#: shared-memory bound (the device-memory scratch path)
CASE_FS = (2, 3, 5, 12, 25, 64, 100, 256, 1000)
BORDER_FS = (63, 65, 127, 128, 129, 511, 512, 1024, 1025)
WIRE_BORDER_FS = (31, 32, 33, 63, 64, 65, 127, 128, 129)
#: the last F of each (T, H) of sigma's team form and the first of the
#: next: T = 1 lane with 2H = 4, 8, 16, 32 and 64 wires up to F = 4, 8,
#: 16, 32 and 64, then T = 2 lanes of 64 wires up to 128
TEAM_BORDER_FS = (4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129)
CUDA_CASES = ([(r, f) for r in KERNELS for f in CASE_FS]
              + [(r, f) for r in ("sigma", "winsorized") for f in BORDER_FS]
              + [(r, f) for r in ("median", "percentile", "sigmedian")
                 for f in WIRE_BORDER_FS if f not in CASE_FS]
              + [("sigma", f) for f in sorted(set(WIRE_BORDER_FS + TEAM_BORDER_FS)
                                             - set(CASE_FS + BORDER_FS))]
              + [(r, 4000) for r in ("sigma", "median", "percentile", "sigmedian")]
              + [("winsorized", 2000)])


#: least warps the winsorized kernel keeps resident per SM at F = 1000:
#: the wires form's 8-warp blocks, 4 to an SM (chip_smoke.py holds the
#: same floor)
MIN_WARPS_F1000 = 32
#: least warps the sigma kernel keeps resident per SM at F = 100: the team
#: form's 8-warp blocks, 3 to an SM (chip_smoke.py holds the same floor)
MIN_WARPS_SIGMA_F100 = 24


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

    # sigma at F = 100: a team of 2 lanes a pixel, 128 pixels a block
    assert tile("sigma", 100) == 128
    assert rs.launch_plan("sigma", 100).warps >= MIN_WARPS_SIGMA_F100
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
    # winsorized: a warp a pixel, 8 pixels a block while they fit; the
    # column in the warp's registers up to F = 2048, past it in shared
    # memory
    assert tile("winsorized", 1000) == 8
    assert tile("winsorized", 14000) == 4
    for f in (1, 1000, 2048):
        assert rs.launch_plan("winsorized", f).form == "wires", f
    assert rs.launch_plan("winsorized", 2049).form == "shared"
    # sigma sorts and clips in the registers of a team of lanes up to
    # F = 128, past it a thread a pixel in shared memory
    for f in (1, 50, 100, 128):
        assert rs.launch_plan("sigma", f).form == "team", f
    assert rs.launch_plan("sigma", 129).form == "shared"
    # past the shared-memory bound the kernels run on a device-memory
    # scratch copy: no F is refused
    assert tile("sigma", 3399) == 32
    assert tile("sigma", 3400) is None
    assert tile("median", 3632) == 32
    assert tile("median", 3633) is None
    assert tile("winsorized", 97000) == 1
    assert rs.launch_plan("winsorized", 97000).form == "shared"
    assert tile("winsorized", 98000) is None
    assert rs.launch_plan("winsorized", 98000).form == "scratch"
    assert rs.launch_plan("winsorized", 1000).warps >= MIN_WARPS_F1000


#: sigma's team form at each of its (T, H) and at the deep-sky F = 100
TEAM_FS = (1, 4, 5, 8, 9, 16, 17, 32, 33, 50, 64, 65, 100, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("F", TEAM_FS)
def test_cuda_sigma_team_aligned_rows(cuda_device, F):
    """The team form on P = 8192 + 72 pixels: rows of a multiple of 16
    bytes, so every block stages its columns by 16-byte row loads, as the
    deep-sky cell's 2^24 pixels are staged, the last block a short one of
    72 pixels (``test_cuda_kernel_matches_plain``'s P = 8192 + 77
    stages by 2-byte loads). One degenerate column in three: mean,
    degenerate flag and both counters equal the plain version's, and the
    launch is counted under the form."""
    p = 8192 + 72
    vals = frames_from_numpy(make_vals(F, p, degen_every=3) if F >= 4 else
                             np.random.default_rng(F).integers(
                                 0, 65536, (F, p)).astype(np.uint16), cuda_device)
    plan = rs.launch_plan("sigma", F, p)
    assert plan.form == "team" and p % plan.tile == 72
    before = counters().get("reject.form.sigma.team", 0)
    got = rs.reject_cuda(vals, "sigma", 2.5, 2.5)
    torch.cuda.synchronize()
    assert counters()["reject.form.sigma.team"] == before + 1
    want = rs.reject_plain(vals, "sigma", 2.5, 2.5)
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=name)
    # the geomspace columns freeze and take the exact re-run (at F = 5 at
    # these sigmas none does)
    assert int(got[1].sum()) > 0 or F == 5


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
@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_cuda_sigma_anchor_cases(cuda_device, case):
    """The sigma kernel on the anchor cases: Siril's clips and mean, and
    no degenerate flag."""
    _, mean, rejl, rejh = ANCHOR_CASES[case]
    got = rs.reject_cuda(anchor_vals(case, cuda_device), "sigma", 3.0, 3.0)
    torch.cuda.synchronize()
    for name, g, w in zip(("mean", "degen", "rejl", "rejh"), got,
                          (mean, 0, rejl, rejh)):
        assert (_ints(g) == w).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
def test_cuda_degenerate_counter(cuda_device, rejection):
    """With tracing on, ``reject_stack`` counts the pixels its kernel
    flagged degenerate as a sum on the card, with no host sync at the
    launch; ``counters()`` reads it."""
    name = f"reject.degenerate.{rejection}"
    vals = frames_from_numpy(make_vals(25, 4096, degen_every=3), cuda_device)
    lo, hi = SIGS[rejection]
    want = int(rs.reject_cuda(vals, rejection, lo, hi)[1].sum())
    assert want > 0
    before = counters().get(name, 0)
    timing.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rs.reject_stack(vals, rejection, lo, hi)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timing.disable()
        timing.collect()
    assert counters()[name] - before == want


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


#: winsorized F across the borders of its wires form (64H wires a warp,
#: H = 2, 4, ..., 32: F up to 128, 256, 512, 1024 and 2048) and just past
#: it, where the shared form takes over
WIRE_FS = (33, 64, 65, 100, 128, 129, 256, 257, 511, 512, 513, 999, 1000,
           1024, 1025, 2047, 2048, 2049)
#: the columns held to the plain version at each of them: make_vals's
#: noise and outliers; columns of one value; zero fill and saturation;
#: knife edges (geomspace columns, each in its own order, whose passes
#: freeze with N - r <= 4: the exact re-run runs from the wires)
WIRE_KINDS = ("random", "equal", "fill", "knife")


def wire_columns(kind: str, f: int, p: int) -> np.ndarray:
    rng = np.random.default_rng(f)
    if kind == "random":
        return make_vals(f, p)
    if kind == "equal":
        level = rng.integers(0, 65536, p)
        level[:3] = (0, 65535, 1000)
        return np.broadcast_to(level.astype(np.uint16), (f, p)).copy()
    if kind == "fill":
        v = np.clip(rng.normal(1000, 10, (f, p)), 0, 65535).astype(np.uint16)
        v[:, 0::4] = 0
        v[:, 1::4] = 65535
        v[:, 2::4] = np.where(rng.random((f, v[:, 2::4].shape[1])) < 0.5, 0, 65535)
        # a drifted frame's zero fill: up to a tenth of a column at 0
        v[:, 3::4][rng.random((f, v[:, 3::4].shape[1])) < 0.1] = 0
        return v
    top = rng.integers(20000, 65536, p)
    return rng.permuted(np.geomspace(1, top, f).astype(np.uint16), axis=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WIRE_KINDS)
@pytest.mark.parametrize("F", WIRE_FS)
def test_cuda_winsorized_wires_matches_plain(cuda_device, F, kind):
    """The wires form (the column sorted and walked in its warp's
    registers) at F across its borders, and the shared form just past it:
    mean, degenerate flag and both counters equal the plain version's,
    and the launch is counted under its form."""
    p = 1024 + 77
    vals = frames_from_numpy(wire_columns(kind, F, p), cuda_device)
    form = "wires" if F <= 2048 else "shared"
    assert rs.launch_plan("winsorized", F, p).form == form
    name = f"reject.form.winsorized.{form}"
    before = counters().get(name, 0)
    got = rs.reject_cuda(vals, "winsorized", 3.0, 3.0)
    torch.cuda.synchronize()
    assert counters()[name] == before + 1
    want = rs.reject_plain(vals, "winsorized", 3.0, 3.0)
    for label, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
        np.testing.assert_array_equal(_ints(g), _ints(w), err_msg=label)
    if kind == "knife":
        assert int(got[1].sum()) > 0, "the knife columns must run the exact re-run"


@pytest.mark.cuda
def test_cuda_winsorized_planetary_frames(cuda_device):
    """The planetary cell's own sequence (the benchmark's generator and
    configuration, one seed): 1000 frames of 480 x 640 aligned on the
    card, stacked by the wires form in one launch, equal to the plain
    version on all 307200 pixels."""
    import importlib.util
    import json

    from siriltpu_torch.pipelines.register_stack import align_frames_auto

    spec = importlib.util.spec_from_file_location(
        "portbench_frames", os.path.join(REPO, "portbench", "core", "frames.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(REPO, "portbench", "configs",
                           "planetary_vga_1000.json")) as fh:
        config = json.load(fh)
    frames, shifts = gen.make_frames(config, 3190001901, cuda_device)
    sx, sy = (torch.from_numpy(np.ascontiguousarray(shifts[:, i])).to(cuda_device)
              for i in (0, 1))
    flat = align_frames_auto(frames, sx, sy).reshape(config["frames"], -1)
    lo, hi = config["sig"]
    assert rs.launch_plan("winsorized", *flat.shape).form == "wires"
    got = rs.reject_cuda(flat, "winsorized", lo, hi)
    torch.cuda.synchronize()
    chunk = 1 << 16
    for a in range(0, flat.shape[1], chunk):
        want = rs.reject_plain(flat[:, a:a + chunk], "winsorized", lo, hi)
        for label, g, w in zip(("mean", "degen", "rejl", "rejh"), got, want):
            np.testing.assert_array_equal(_ints(g[a:a + chunk]), _ints(w),
                                          err_msg=f"{label} from pixel {a}")
