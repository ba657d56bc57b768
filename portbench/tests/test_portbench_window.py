"""The closed loop's arithmetic: a rate over the whole window with the
straddling last sequence counted, the tail over every sequence, the
sample drawn from the seed; and the roofline bytes from shapes."""

import random
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.core import roofline  # noqa: E402
from portbench.core.spans import union_seconds  # noqa: E402
from portbench.core.trace import merge, name_gaps, top  # noqa: E402
from portbench.core.window import Reservoir, closed_loop, percentile  # noqa: E402


class Clock:
    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        return self.t

    def advance(self):
        self.t += self.steps.pop(0)


def test_rate_and_tail_count_the_straddling_sequence():
    clock = Clock([3.0, 4.0, 5.0])   # three sequences; the last straddles 10 s

    def call():
        clock.advance()
        return "out", 100

    w = closed_loop(call, 10.0, clock=clock)
    assert len(w.sequences) == 3 and w.frames == 300
    assert w.seconds == 12.0 and w.rate() == 25.0
    assert w.durations_ms() == [3000.0, 4000.0, 5000.0]
    assert percentile(w.durations_ms(), 95) == pytest.approx(4900.0)


def test_a_window_runs_one_sequence_at_least():
    clock = Clock([30.0])

    def call():
        clock.advance()
        return None, 1000

    w = closed_loop(call, 10.0, clock=clock)
    assert len(w.sequences) == 1 and w.rate() == pytest.approx(1000 / 30.0)


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys_linear_one(q):
    v = list(np.random.default_rng(1).random(37))
    assert percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def test_the_sample_is_drawn_from_the_seed():
    picks = []
    for seed in range(400):
        r = Reservoir(random.Random(seed))
        for i in range(4):
            r(i, f"out{i}")
        assert r.result == f"out{r.index}"
        picks.append(r.index)
    again = Reservoir(random.Random(7))
    for i in range(4):
        again(i, i)
    assert again.index == picks[7]
    assert set(picks) == {0, 1, 2, 3} and min(np.bincount(picks)) > 60


def test_roofline_bytes_from_shapes():
    f, p = 100, 4096 * 4096
    assert roofline.stack_bytes(f, p) == 2 * f * p + 2 * p
    t = roofline.stack_bytes(f, p) / 3.35e12
    assert roofline.share_pct(roofline.stack_bytes(f, p), t) == pytest.approx(100.0)
    assert roofline.share_pct(roofline.stack_bytes(f, p), 10 * t) == pytest.approx(10.0)


def test_intervals_and_gaps():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]

    class Ev:
        def __init__(self, a, d, name):
            self.a, self.d, self.n = a, d, name

        def start_ns(self):
            return self.a

        def duration_ns(self):
            return self.d

        def name(self):
            return self.n

    host = [Ev(0, 100, "span:outer"), Ev(10, 20, "aten::copy_"), Ev(50, 10, "aten::sort")]
    gaps = [(12, 18), (40, 48), (200, 210)]
    named = name_gaps(gaps, host)
    assert named == pytest.approx({"aten::copy_": 6e-9, "span:outer": 8e-9,
                                   "(outside any op)": 1e-8})
    assert top({"a": 1.0, "b": 3.0}) == [["b", 3.0], ["a", 1.0]]
