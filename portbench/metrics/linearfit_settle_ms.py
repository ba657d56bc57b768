"""Device ms a sequence spends in the program's float64 settle of the
linear fit's knife-edge pixels: the CUDA-event time of
``reject_stack.linearfit_settle``, summed a sequence; the median over the
window's sequences that settle any pixel. None where the program has no
such function."""

import statistics

LAYER, UNIT, MOVES = "rejection kernels", "ms", "frames_per_s"


def read(run):
    if run.spans is None:
        return None
    ms = run.spans.device_ms_per_sequence("linearfit_settle")
    return statistics.median(ms) if ms else None
