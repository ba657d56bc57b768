"""The closed loop and its arithmetic. One user runs whole sequences back
to back; each call returns its result to the host before the next starts.
New sequences start until ``seconds`` have passed since the window
opened; the one that straddles the close is finished and counted."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float
    #: (start, end, frames) of every sequence, host clock, in order
    sequences: list = field(default_factory=list)

    @property
    def end(self) -> float:
        return self.sequences[-1][1]

    @property
    def seconds(self) -> float:
        """From the window's opening to the end of its last sequence."""
        return self.end - self.start

    @property
    def frames(self) -> int:
        return sum(s[2] for s in self.sequences)

    def rate(self) -> float:
        """Frames a second over the whole window."""
        return self.frames / self.seconds

    def durations_ms(self) -> list:
        return [1e3 * (b - a) for a, b, _ in self.sequences]


def percentile(values, q: float) -> float:
    """The q-th percentile, linearly between the two nearest ranks (numpy's
    default): rank (n - 1) * q / 100 of the sorted values."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def closed_loop(call, seconds: float, keep=None,
                clock=time.perf_counter) -> Window:
    """Run ``call()``, which returns (result, frames), until ``seconds``
    have passed. ``keep(i, result)`` sees every result (to sample one for
    the check)."""
    window = Window(start=clock())
    while not window.sequences or clock() - window.start < seconds:
        t0 = clock()
        result, frames = call()
        window.sequences.append((t0, clock(), frames))
        if keep is not None:
            keep(len(window.sequences) - 1, result)
    return window


class Reservoir:
    """Keeps one of the results it is shown, each as likely as the others,
    drawn from ``rng`` (a random.Random seeded from the run's seed)."""

    def __init__(self, rng):
        self.rng = rng
        self.index, self.result = -1, None

    def __call__(self, i: int, result) -> None:
        if self.rng.randrange(i + 1) == 0:
            self.index, self.result = i, result


__all__ = ["Window", "percentile", "closed_loop", "Reservoir"]
