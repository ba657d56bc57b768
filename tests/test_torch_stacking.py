"""siriltpu_torch.stacking.api.stack_frames and stack_sequence against
siriltpu's, bit for bit: the stacked image and the per-channel rejection
counters, for every method, every rejection with a kernel (and none),
linearfit with its exact host re-run, three normalizations, mono and
colour, with shifts, at the default block
size and at 7 rows (block edges inside the image); stack_sequence from a
SER file and from FITS files, with the frames read whole and streamed in
row blocks.

On the CPU the mean and median stacks run the kernels' plain versions;
the ``cuda`` cases at the end run the kernels on the card.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from siriltpu_torch.stacking import api as tapi  # noqa: E402
from siriltpu_torch.utils.timing import counters  # noqa: E402

F, H, W = 12, 24, 40
#: (siglow, sighigh) per rejection; percentile takes (plow, phigh)
SIGS = {"none": (3.0, 3.0), "sigma": (3.0, 3.0), "percentile": (0.2, 0.1),
        "sigmedian": (3.0, 3.0), "winsorized": (3.0, 3.0),
        "linearfit": (2.0, 1.5)}


def counted(name: str):
    """A counter of the program's tracing, 0 before its first count."""
    return counters().get(name, 0)


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
                                       "sigmedian", "winsorized", "linearfit"])
def test_stack_frames_mean_matches_jax(rejection, normalize, c):
    from siriltpu.stacking import api as japi

    frames = make_frames(c)
    kw = dict(method="mean", shifts=SHIFTS, rejection=rejection,
              sig=SIGS[rejection], normalize=normalize)
    want = japi.stack_frames(frames, **kw)
    if rejection != "none":
        assert want.rejection_low.sum() > 0 and want.rejection_high.sum() > 0
    for block_rows in (None, 7):
        knife = counted("linearfit.knife")
        _assert_same(tapi.stack_frames(frames, device="cpu",
                                       block_rows=block_rows, **kw), want)
        if rejection == "linearfit":
            # the exact host re-run of knife-edge pixels took part
            assert counted("linearfit.knife") > knife


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


# ------------------------------------------------------------ stack_sequence

def open_sequences(tmp_path, frames, kind="ser"):
    """The frames written to disk once, as a SER file or as numbered FITS
    files, and opened by both packages, with SHIFTS as the registration
    data of layer 0 and frame 5 excluded."""
    from siriltpu.core.frame import Frame
    from siriltpu.io import fits as jfits
    from siriltpu.io import sequence as jsequence
    from siriltpu.io.ser import SER_MONO, SER_RGB, SerFile
    from siriltpu_torch.io import sequence as tsequence

    d = str(tmp_path)
    if kind == "ser":
        path = os.path.join(d, "cap.ser")
        ser = SerFile.create(path, W, H, color_id=SER_RGB if frames.shape[1] == 3
                             else SER_MONO)
        for fr in frames:
            ser.write_frame(Frame(fr))
        ser.write_and_close()
        seqs = jsequence.ser_sequence(path), tsequence.ser_sequence(path)
    else:
        for i, fr in enumerate(frames):
            jfits.write_fits(os.path.join(d, f"img{i:03d}.fit"), Frame(fr))
        jseq = jsequence.check_seq(d)[0]
        seqs = jseq, tsequence.check_seq(d)[0]
    for seq in seqs:
        for r, (sx, sy) in zip(seq.ensure_regparam(0), SHIFTS):
            r.shiftx, r.shifty = int(sx), int(sy)
        seq.set_included(5, False)
    return seqs


def _assert_sequence_stacks(tmp_path, frames, kw, kind="ser"):
    """stack_sequence with the frames read whole and streamed (in blocks
    of 7 rows and at its default) equals siriltpu's and the port's
    stack_frames on the frames it selects."""
    from siriltpu.stacking import api as japi

    jseq, tseq = open_sequences(tmp_path, frames, kind)
    want = japi.stack_sequence(jseq, stream=False, **kw)
    keep = [i for i in range(F) if i != 5]
    assert want.total_pixels == len(keep) * frames[0].size
    for stream, block_rows in ((False, None), (True, 7), (True, None)):
        blocks = counted("stack.blocks")
        got = tapi.stack_sequence(tseq, device="cpu", stream=stream,
                                  block_rows=block_rows, **kw)
        _assert_same(got, want)
        if stream and kw["method"] in ("mean", "median"):
            assert counted("stack.blocks") - blocks == frames.shape[1] * (
                -(-H // block_rows) if block_rows else 1)
    coeffs = None
    if kw.get("normalize", "none") != "none":
        coeffs = tapi.sequence_normalization(tseq, 0, keep, kw["normalize"])
    _assert_same(tapi.stack_frames(frames[keep], device="cpu", shifts=SHIFTS[keep],
                                   coeffs=coeffs, **kw), want)
    return want


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("normalize", ["none", "additive_scaling"])
@pytest.mark.parametrize("rejection", ["none", "sigma", "percentile",
                                       "sigmedian", "winsorized", "linearfit"])
def test_stack_sequence_mean_matches_jax(tmp_path, rejection, normalize, c):
    kw = dict(method="mean", rejection=rejection, sig=SIGS[rejection],
              normalize=normalize)
    want = _assert_sequence_stacks(tmp_path, make_frames(c, seed=2), kw)
    if rejection != "none":
        assert want.rejection_low.sum() > 0 and want.rejection_high.sum() > 0


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("method,normalize", [
    ("sum", "none"), ("max", "none"), ("min", "none"), ("median", "none"),
    ("median", "multiplicative_scaling")])
def test_stack_sequence_methods_match_jax(tmp_path, method, normalize, c):
    _assert_sequence_stacks(tmp_path, make_frames(c, seed=3),
                            dict(method=method, normalize=normalize))


@pytest.mark.parametrize("method,rejection", [("mean", "winsorized"),
                                              ("median", "none")])
def test_stack_sequence_from_fits_files_matches_jax(tmp_path, method, rejection):
    """The streaming stack reads its row blocks from FITS files by partial
    reads; siriltpu's streaming stack gives the same image."""
    from siriltpu.stacking import api as japi

    frames = make_frames(1, seed=4)
    kw = dict(method=method, rejection=rejection, sig=(3.0, 3.0),
              normalize="additive")
    want = _assert_sequence_stacks(tmp_path, frames, kw, kind="regular")
    jseq, _ = open_sequences(tmp_path, frames, kind="regular")
    _assert_same(japi.stack_sequence(jseq, stream=True, **kw), want)


def test_stack_sequence_filters_and_streams_by_memory(tmp_path, monkeypatch):
    from siriltpu.stacking import api as japi

    frames = make_frames(1, seed=5)
    jseq, tseq = open_sequences(tmp_path, frames)
    for seq in (jseq, tseq):
        for r, q in zip(seq.regparam[0], np.linspace(0.05, 1.0, F)):
            r.quality = float(q)
    kw = dict(method="mean", rejection="sigma", filter_type="best_quality",
              filter_param=50.0)
    want = japi.stack_sequence(jseq, stream=False, **kw)
    assert want.total_pixels == len(tapi.filter_indices(
        tseq, filter_type="best_quality", param=50.0)) * H * W
    # with memory to spare the frames are read whole...
    blocks = counted("stack.blocks")
    _assert_same(tapi.stack_sequence(tseq, device="cpu", **kw), want)
    assert counted("stack.blocks") == blocks
    # ...and streamed once the sequence is more than a quarter of it
    monkeypatch.setattr(tapi, "get_available_memory_mb", lambda: 0)
    _assert_same(tapi.stack_sequence(tseq, device="cpu", **kw), want)
    assert counted("stack.blocks") == blocks + 1


def test_stack_sequence_rejects_unported_and_bad_arguments(tmp_path):
    _, tseq = open_sequences(tmp_path, make_frames(1))
    for stream in (False, True):
        with pytest.raises(ValueError, match="unknown rejection"):
            tapi.stack_sequence(tseq, device="cpu", rejection="bogus", stream=stream)
    with pytest.raises(TypeError):
        tapi.stack_sequence(tseq)  # no device
    for i in range(1, F):
        tseq.set_included(i, False)
    with pytest.raises(ValueError, match="at least 2"):
        tapi.stack_sequence(tseq, device="cpu")


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
    before = counted(f"reject.launches.{kernel}")
    got = tapi.stack_frames(frames, device=cuda_device, **kw)
    assert counted(f"reject.launches.{kernel}") > before
    _assert_same(got, tapi.stack_frames(frames, device="cpu", **kw))


@pytest.mark.cuda
def test_cuda_stack_frames_linearfit_matches_cpu(cuda_device):
    """linearfit has no kernel: on the card the f32 fit is plain PyTorch,
    whose sums over F run in another order than the CPU's, and the exact
    host re-run of the knife-edge pixels makes the two results equal."""
    frames = make_frames(3)
    kw = dict(method="mean", shifts=SHIFTS, rejection="linearfit",
              sig=SIGS["linearfit"], normalize="additive_scaling", block_rows=7)
    knife = counted("linearfit.knife")
    got = tapi.stack_frames(frames, device=cuda_device, **kw)
    assert counted("linearfit.knife") > knife
    _assert_same(got, tapi.stack_frames(frames, device="cpu", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("method,rejection", [
    ("median", "none"), ("mean", "sigma"), ("mean", "winsorized")])
def test_cuda_stack_sequence_matches_cpu(cuda_device, tmp_path, method,
                                         rejection, stream):
    """On the card a sequence on disk, read whole or streamed through
    pinned buffers and a side stream, stacks through the kernel to the CPU
    route's result."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.io.ser import SER_RGB, SerFile

    frames = make_frames(3)
    path = str(tmp_path / "cap.ser")
    ser = SerFile.create(path, W, H, color_id=SER_RGB)
    for fr in frames:
        ser.write_frame(Frame(fr))
    ser.write_and_close()
    seq = ser_sequence(path)
    for r, (sx, sy) in zip(seq.ensure_regparam(0), SHIFTS):
        r.shiftx, r.shifty = int(sx), int(sy)
    kw = dict(method=method, rejection=rejection, sig=SIGS[rejection],
              normalize="additive_scaling", block_rows=7, stream=stream)
    kernel = "median" if method == "median" else rejection
    before = counted(f"reject.launches.{kernel}")
    got = tapi.stack_sequence(seq, device=cuda_device, **kw)
    assert counted(f"reject.launches.{kernel}") >= before + 3 * 4
    _assert_same(got, tapi.stack_sequence(seq, device="cpu", **kw))
