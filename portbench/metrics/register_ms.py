"""Device ms of a sequence's registration: the CUDA-event times of
``register_stack.compute_shifts`` (batched phase correlation, cuFFT) and
``register_stack.quality_estimate_batch``, summed a sequence; the median
over the window's sequences."""

import statistics

LAYER, UNIT, MOVES = "registration", "ms", "frames_per_s"


def read(run):
    if run.spans is None:
        return None
    ms = run.spans.device_ms_per_sequence("compute_shifts", "quality_estimate_batch")
    return statistics.median(ms) if ms else None
