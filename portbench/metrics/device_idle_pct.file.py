"""The share of the traced window in which no operation ran on the card
(torch.profiler's kernels, copies and sets), in the cells that stack
from a file."""

from portbench.core.trace import idle_pct

LAYER, UNIT, MOVES = "device", "%", "file_frames_per_s"


def read(run):
    return idle_pct(run)
