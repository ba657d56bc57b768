"""siriltpu_torch.stacking.api.stack_frames against siriltpu's, bit for
bit: the stacked image and the per-channel rejection counters, for every
method, every rejection with a kernel (and none), three normalizations,
mono and colour, with shifts, at the default block size and at 7 rows
(block edges inside the image).

On the CPU the mean and median stacks run the kernels' plain versions;
the ``cuda`` case at the end runs the kernels on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.ops.cuda import reject_stack as rs  # noqa: E402
from siriltpu_torch.stacking import api as tapi  # noqa: E402

F, H, W = 12, 24, 40
#: (siglow, sighigh) per rejection; percentile takes (plow, phigh)
SIGS = {"none": (3.0, 3.0), "sigma": (3.0, 3.0), "percentile": (0.2, 0.1),
        "sigmedian": (3.0, 3.0), "winsorized": (3.0, 3.0)}


def make_frames(c: int, seed: int = 0) -> np.ndarray:
    """(F, C, H, W) uint16 sky around 1000 with a per-frame level, cold
    (0) and hot (60000) outliers and real 65535 values."""
    rng = np.random.default_rng(seed + c)
    fr = rng.normal(1000, 40, (F, c, H, W)) + rng.integers(-100, 100, F)[:, None, None, None]
    fr = np.clip(fr, 0, 65535).astype(np.uint16)
    for v in (60000, 0):
        fr[rng.integers(0, F, 60), rng.integers(0, c, 60),
           rng.integers(0, H, 60), rng.integers(0, W, 60)] = v
    fr[:, :, ::5, ::7] = 65535
    return fr


SHIFTS = np.random.default_rng(7).integers(-3, 4, (F, 2)).astype(np.int32)


def _assert_same(got, want):
    assert got.data.dtype == np.uint16 and got.data.shape == want.data.shape
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.rejection_low, want.rejection_low)
    np.testing.assert_array_equal(got.rejection_high, want.rejection_high)
    assert got.total_pixels == want.total_pixels


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("normalize", ["none", "additive_scaling",
                                       "multiplicative"])
@pytest.mark.parametrize("rejection", ["none", "sigma", "percentile",
                                       "sigmedian", "winsorized"])
def test_stack_frames_mean_matches_jax(rejection, normalize, c):
    from siriltpu.stacking import api as japi

    frames = make_frames(c)
    kw = dict(method="mean", shifts=SHIFTS, rejection=rejection,
              sig=SIGS[rejection], normalize=normalize)
    want = japi.stack_frames(frames, **kw)
    if rejection != "none":
        assert want.rejection_low.sum() > 0 and want.rejection_high.sum() > 0
    for block_rows in (None, 7):
        _assert_same(tapi.stack_frames(frames, device="cpu",
                                       block_rows=block_rows, **kw), want)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("method,normalize", [
    ("sum", "none"), ("max", "none"), ("min", "none"), ("median", "none"),
    ("median", "additive_scaling"), ("median", "multiplicative")])
def test_stack_frames_methods_match_jax(method, normalize, c):
    from siriltpu.stacking import api as japi

    frames = make_frames(c, seed=1)
    kw = dict(method=method, shifts=SHIFTS, normalize=normalize)
    want = japi.stack_frames(frames, **kw)
    for block_rows in (None, 7):
        _assert_same(tapi.stack_frames(frames, device="cpu",
                                       block_rows=block_rows, **kw), want)
    # a tensor input gives the same result
    got = tapi.stack_frames(torch.from_numpy(frames.view(np.int16)).view(torch.uint16),
                            device="cpu", **kw)
    _assert_same(got, want)


def test_stack_summary_matches_jax():
    from siriltpu.stacking import api as japi

    for method in tapi.METHODS:
        for rejection in ("none", "percentile", "sigma", "sigmedian",
                          "winsorized", "linearfit"):
            for normalize in tapi.NORM_MODES:
                args = (F, method, rejection, (2.5, 3.0), normalize)
                assert (tapi.stack_summary(*args)
                        == japi.stack_summary(*args))


def test_stack_frames_rejects_unported_and_bad_arguments():
    frames = make_frames(1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 2"):
        tapi.stack_frames(frames, device="cpu", rejection="linearfit")
    with pytest.raises(ValueError):
        tapi.stack_frames(frames, device="cpu", rejection="bogus")
    with pytest.raises(ValueError):
        tapi.stack_frames(frames, device="cpu", method="bogus")
    with pytest.raises(ValueError):
        tapi.stack_frames(frames[:, 0], device="cpu")


def test_default_block_rows_matches_jax():
    from siriltpu.stacking import api as japi

    for f, w in ((12, 40), (50, 2048), (1000, 640), (100000, 4096)):
        assert tapi.default_block_rows(f, w) == japi.default_block_rows(f, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rejection kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method,rejection", [
    ("median", "sigma"), ("mean", "sigma"), ("mean", "percentile"),
    ("mean", "sigmedian"), ("mean", "winsorized")])
def test_cuda_stack_frames_matches_cpu(cuda_device, method, rejection):
    """On the card the same stack goes through the kernel and equals the
    CPU route (the plain versions)."""
    frames = make_frames(3)
    kw = dict(method=method, shifts=SHIFTS, rejection=rejection,
              sig=SIGS[rejection], normalize="additive_scaling", block_rows=7)
    kernel = "median" if method == "median" else rejection
    before = rs.launches[kernel]
    got = tapi.stack_frames(frames, device=cuda_device, **kw)
    assert rs.launches[kernel] > before
    _assert_same(got, tapi.stack_frames(frames, device="cpu", **kw))
