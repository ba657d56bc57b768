"""Host seconds a sequence spends in ``api.sequence_normalization`` (each
frame read again and its statistics computed on the host), the mean over
the window's sequences."""

import statistics

LAYER, UNIT, MOVES = "normalization", "s", "file_frames_per_s"


def read(run):
    if run.spans is None:
        return None
    s = run.spans.host_s_per_sequence("sequence_normalization")
    return statistics.fmean(s) if s else None
