"""Host seconds a sequence spends in ``translation.register_shift_dft``
(its file reads, host quality and device phase correlation), the mean
over the window's sequences."""

import statistics

LAYER, UNIT, MOVES = "registration driver", "s", "file_frames_per_s"


def read(run):
    if run.spans is None:
        return None
    s = run.spans.host_s_per_sequence("register_shift_dft")
    return statistics.fmean(s) if s else None
