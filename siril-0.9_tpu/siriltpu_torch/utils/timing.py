"""Wall-clock timing (the reference's gettimeofday + show_time pairs
around every long operation, SURVEY §5.1) and an optional profiler hook.

Port of ``siriltpu.utils.timing``: the host timer is copied; the device
trace is ``torch.profiler``'s (a Chrome trace) in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time


def format_time(seconds: float) -> str:
    """show_time formatting (core/utils.c)."""
    if seconds >= 3600:
        return f"{seconds / 3600:.2f} h"
    if seconds >= 60:
        return f"{seconds / 60:.2f} min"
    if seconds >= 1:
        return f"{seconds:.2f} s"
    return f"{seconds * 1000:.2f} ms"


@contextlib.contextmanager
def timed(label: str, log=print):
    t0 = time.perf_counter()
    yield
    log(f"Execution time [{label}]: {format_time(time.perf_counter() - t0)}")


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the host and, where there is one, the CUDA
    card around a block, written to ``logdir/trace.json`` (open it in
    Perfetto or chrome://tracing)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


__all__ = ["timed", "format_time", "device_trace"]
