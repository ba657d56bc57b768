"""Wall-clock timing (the reference's gettimeofday + show_time pairs
around every long operation, SURVEY §5.1), and the port's tracing: spans,
counters and a profiler hook.

Port of ``siriltpu.utils.timing``: the host timer is copied; the device
trace is ``torch.profiler``'s (a Chrome trace) in place of ``jax.profiler``.

Tracing is off by default, and then ``span`` returns one shared object
that does nothing, after a single flag test. ``enable()`` turns it on:
each ``with span(name, ...)`` then becomes a ``torch.profiler`` range of
that name, stamps its host start and end, and, given the CUDA device its
work is queued on, records a pair of CUDA events on that device's current
stream. A span never waits for the device; the events are read in
``collect()``, which hands out the spans kept so far and forgets them.
The stamps are nanoseconds on the profiler's own clock (the Unix epoch,
as its events' ``start_ns()``): a span kept here and the kernels and gaps
of a profiler trace lie on one axis. Counters (``count``) are always on;
the program counts once a call, never once a frame or a pixel.

Span names are the program's stages and stay the same whatever code runs
under them: ``register_and_stack``, ``register.shifts``,
``register.quality``, ``align.shift_read``, ``align.copy``,
``stack.reject``, ``result.to_host``; ``stack_sequence``, ``stack_frames``,
``stack.normalize``, ``stack.read``, ``stack.read_block``, ``stack.wait``,
``stack.block``, ``stack.linearfit_fixup``; ``global.read``,
``global.wait``, ``global.starfind``, ``global.match``, ``global.warp``,
``global.copy``, ``global.write``; ``ecc.read``, ``ecc.device``,
``ecc.quality``. Counters: ``reject.launches.<kernel>``,
``reject.form.<rejection>.<form>`` (launches of a kernel in each form:
``wires``, ``shared`` or ``scratch``), ``stack.blocks`` (row blocks a
streaming stack read from the files), ``linearfit.knife``; and, while
tracing is on only,
``reject.degenerate.<rejection>`` (pixels a window kernel flagged
degenerate and the exact masked loop settled), a sum the device keeps
until ``counters()`` reads it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_on = False             # the one flag the off path tests
_device_time = True     # CUDA events in spans given a CUDA device
_offset_ns = 0          # the profiler's clock less time.perf_counter_ns
_records = []           # closed spans, until collect()
_counters = {}
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans
_ids = itertools.count(1)


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


# -------------------------------------------------------------------- spans

def enable(device_time: bool = True) -> None:
    """Turn spans on. ``device_time`` False keeps CUDA events out of them.
    The profiler stamps its events on the Unix epoch; spans stamp the
    monotonic clock plus the one offset taken here."""
    global _on, _device_time, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _device_time = device_time
    _on = True


def enabled() -> bool:
    """Whether spans are on: the test for work that only tracing wants."""
    return _on


def disable() -> None:
    """Turn spans off; the spans kept so far stay for ``collect()``."""
    global _on
    _on = False


def reset() -> None:
    """Forget the spans kept and set every counter to 0."""
    with _lock:
        _records.clear()
        _counters.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span. ``parent`` is the id of the span open around it on its
    thread (or the one it was given), ``root`` the id of the outermost
    span of its call; ``start_ns`` and ``end_ns`` are host stamps on the
    profiler's clock; ``device_ms`` is its CUDA-event time, filled by
    ``collect()``, or None."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "attrs", "device_ms", "_adopt", "_events", "_range")

    def __init__(self, name: str, device, parent, attrs: dict):
        self.name, self.attrs, self._adopt = name, attrs, parent
        self.id = next(_ids)
        self.thread = threading.get_ident()
        self.parent = self.root = None
        self.start_ns = self.end_ns = 0
        self.device_ms = None
        self._events = None
        if (_device_time and device is not None
                and torch.device(device).type == "cuda"):
            stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open (the form a
        launch took)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else self._adopt
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.start_ns = time.perf_counter_ns() + _offset_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns() + _offset_ns
        if self._events is not None:
            self._events[1].record(self._events[2])
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        with _lock:
            _records.append(self)
        return False


class _Off:
    """What ``span`` returns while tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, device=None, parent=None, **attrs):
    """A stage of the program, as a context manager. ``device``: the
    ``torch.device`` its work is queued on (a CUDA one gets CUDA events);
    ``parent``: for a span on a worker thread, the span (``current()``)
    of the call it works for, where its own thread has none open;
    ``attrs``: plain values kept with it (shapes, rejection, bytes)."""
    if not _on:
        return _OFF
    return Span(name, device, parent, attrs)


def current():
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def collect() -> list:
    """The spans closed since the last call, oldest first, with their
    device times read (a wait for the events only); forgotten here."""
    with _lock:
        out = list(_records)
        _records.clear()
    for s in out:
        if s._events is not None:
            start, end, _ = s._events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
            s._events = None
    return out


# ------------------------------------------------------------------ counters

def count(name: str, n=1) -> None:
    """Add ``n`` to a counter. ``n`` may be a 0-d tensor on the device:
    it is added there, with no host read, until ``counters()``."""
    with _lock:
        _counters[name] = n if name not in _counters else _counters[name] + n


def counters() -> dict:
    """Every counter's value; a device sum is read to the host here."""
    with _lock:
        out = dict(_counters)
    return {k: v.item() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


# ------------------------------------------------------------------- reading

def totals(spans) -> dict:
    """Host seconds of ``spans`` summed by name."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the host and, where there is one, the CUDA
    card around a block, written to ``logdir/trace.json`` (open it in
    Perfetto or chrome://tracing). Spans are on for the block, so the
    trace names the program's stages over the device's kernels; spans it
    turned on are not kept."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    if not was_on:
        with _lock:
            kept = len(_records)
        enable(device_time=False)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            disable()
            with _lock:
                del _records[kept:]
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


__all__ = ["timed", "format_time", "device_trace", "enable", "enabled",
           "disable", "reset", "span", "current", "collect", "count",
           "counters", "totals", "Span"]
