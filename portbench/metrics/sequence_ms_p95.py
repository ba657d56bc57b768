"""The 95th percentile of the host-clock time of a sequence, from the call
to its result on the host, over every sequence of the window."""

from portbench.core.window import percentile


def read(run):
    return percentile(run.window.durations_ms(), 95)
