"""Seconds from the start of the run's process to its first timed
sequence: imports, the CUDA context, the library loaded (or built, in a
checkout's first run), the inputs made and written, the warm-up."""


def read(run):
    return run.setup_s
