"""Host seconds a sequence spends reading its SER file: the time in which
at least one of the opened sequence's ``read_frame`` or
``read_frame_part`` ran, on any thread; the mean over the window's
sequences."""

import statistics

LAYER, UNIT, MOVES = "file read", "s", "file_frames_per_s"


def read(run):
    if run.spans is None:
        return None
    s = run.spans.host_s_per_sequence("read_frame", "read_frame_part", union=True)
    return statistics.fmean(s) if s else None
