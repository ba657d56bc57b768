"""The share of the traced window in which no operation ran on the card
(torch.profiler's kernels, copies and sets), in the resident cells."""

from portbench.core.trace import idle_pct

LAYER, UNIT, MOVES = "device", "%", "frames_per_s"


def read(run):
    return idle_pct(run)
