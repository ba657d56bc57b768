"""Device ms of a sequence's alignment: the CUDA-event time of
``register_stack.align_frames_auto`` (its host read of the shifts
included); the median over the window's sequences."""

import statistics

LAYER, UNIT, MOVES = "align", "ms", "frames_per_s"


def read(run):
    if run.spans is None:
        return None
    ms = run.spans.device_ms_per_sequence("align_frames_auto")
    return statistics.median(ms) if ms else None
