"""The plain reference on tiny inputs: its rejection stacks, quality, IKSS
and phase correlation agree with the program's plain versions and the
NumPy oracle of Siril's loops (here only, in a test; the reference itself
imports nothing of the program), its shifts undo the generated drift,
and its control computed a precision step lower departs from it."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(Path(__file__).resolve().parent), str(REPO), str(REPO / "siril-0.9_tpu")]

import tiny  # noqa: E402
from portbench.core import frames as gen  # noqa: E402
from portbench.core import reference as ref  # noqa: E402

STATED = {"correlation": "float32", "quality": "float32", "statistics": "float32",
          "ikss": "float64", "normalize": "float32"}


def columns(f, p, seed):
    """(F, P) uint16 columns around 1000 with cold and hot outliers and a
    few columns of equal values."""
    rng = np.random.default_rng(seed)
    v = np.clip(rng.normal(1000, 30, (f, p)), 0, 65535).astype(np.uint16)
    v[rng.integers(0, f, p // 6), rng.integers(0, p, p // 6)] = 0
    v[rng.integers(0, f, p // 6), rng.integers(0, p, p // 6)] = 60000
    v[:, ::17] = 1234
    return torch.from_numpy(v.view(np.int16)).view(torch.uint16)


@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
@pytest.mark.parametrize("f", [3, 7, 12, 40])
def test_rejection_matches_the_programs_plain_version(rejection, f):
    from siriltpu_torch.ops.rejection import reject_and_mean

    vals = columns(f, 600, f)
    mean, low, high = ref.stack(vals, rejection, (2.5, 2.0), ref.Precision(),
                                block_values=f * 128)
    pm, pl, ph = reject_and_mean(vals, rejection, (2.5, 2.0))
    assert torch.equal(mean.view(torch.int16), pm.view(torch.int16))
    assert (low, high) == (int(pl.sum()), int(ph.sum()))


@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
def test_rejection_matches_the_oracle(rejection):
    from siriltpu_torch.verify import oracle

    f, p = 9, 40
    vals = columns(f, p, 3)
    mean, _, _ = ref.stack(vals, rejection, (2.0, 2.0), ref.Precision())
    host = vals.view(torch.int16).numpy().view(np.uint16)
    want = oracle.stack_mean_rejection(host.reshape(f, 1, 1, p),
                                       np.zeros((f, 2), np.int32), rejection, (2.0, 2.0))
    want = np.asarray(want).reshape(-1)
    assert np.array_equal(mean.view(torch.int16).numpy().view(np.uint16), want)


def test_quality_and_ikss_match_the_program():
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.ops.quality import quality_estimate
    from siriltpu_torch.ops.stats import STATS_EXTRA, statistics

    frames, _ = gen.make_frames(tiny.TINY, 11, "cpu")
    host = gen.u16_to_numpy(frames)
    for layer in host[:3]:
        assert ref.quality(layer, ref.Precision()) == quality_estimate(layer)
        st = statistics(Frame(layer), 0, option=STATS_EXTRA)
        counts = np.bincount(layer.reshape(-1), minlength=65536)
        loc, scale = ref.ikss(counts, 65535.0, ref.Precision())
        assert loc == pytest.approx(st.location, rel=1e-12)
        assert scale == pytest.approx(st.scale, rel=1e-12)


def test_shifts_undo_the_generated_drift():
    frames, truth = gen.make_frames(tiny.TINY, 12, "cpu")
    s = tiny.TINY["selection"]
    sel = ((tiny.TINY["width"] - s) // 2, (tiny.TINY["height"] - s) // 2, s)
    assert np.array_equal(ref.phase_shifts(frames, sel, ref.Precision()), truth)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_the_control_departs_from_the_reference(seed):
    frames, truth = gen.make_frames(tiny.TINY, seed, "cpu")
    flat = ref.align(frames, truth).reshape(frames.shape[0], -1)
    low = ref.Precision.below(STATED)
    a, _, _ = ref.stack(flat, "sigma", (3, 3), ref.Precision())
    b, _, _ = ref.stack(flat, "sigma", (3, 3), low)
    assert int((a.view(torch.int16) != b.view(torch.int16)).sum()) > 0
