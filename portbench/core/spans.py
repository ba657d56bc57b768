"""Spans around calls into the program, recorded from the benchmark's side
in a traced run: each wrapped function keeps, per call, the sequence it
ran in, its host start and end, the shapes and plain values of its
arguments and, on the main thread of a CUDA run, two CUDA events whose
elapsed time is the call's device time. Each call is also a
``torch.profiler`` annotation named ``span:<name>``, so the trace can say
what the host was doing in an idle gap.

A target that the program no longer has is skipped: the metrics that read
its span then have nothing to read and report null.
"""

from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class Span:
    sequence: int
    start: float
    end: float
    args: tuple
    events: tuple = None   # (start, end) torch.cuda.Event, or None

    def device_ms(self):
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


def _describe(a):
    if hasattr(a, "shape"):
        return tuple(a.shape)
    return a if isinstance(a, (str, int, float, bool)) else None


class Spans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.sequence = -1
        #: the sequences before this one ran under the profiler, whose
        #: overhead is not the program's: readings skip them where later
        #: sequences have the span
        self.first_clean = 0
        self.records = defaultdict(list)
        self._lock = threading.Lock()
        self._undo = []

    def wrap(self, owner, attr: str, name: str, device_time: bool = True) -> bool:
        """Replace ``owner.attr`` (a module, given by object or dotted name,
        or an instance) by a recording wrapper; False where it has none."""
        import torch

        if isinstance(owner, str):
            try:
                owner = importlib.import_module(owner)
            except ImportError:
                return False
        fn = getattr(owner, attr, None)
        if fn is None:
            return False

        def wrapped(*args, **kwargs):
            events = None
            if (device_time and self.cuda
                    and threading.current_thread() is threading.main_thread()):
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            with torch.profiler.record_function(f"span:{name}"):
                if events:
                    events[0].record()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter()
                    if events:
                        events[1].record()
                    span = Span(self.sequence, t0, t1,
                                tuple(_describe(a) for a in args), events)
                    with self._lock:
                        self.records[name].append(span)

        self._undo.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
        setattr(owner, attr, wrapped)
        return True

    def restore(self) -> None:
        for owner, attr, old in reversed(self._undo):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()

    # --------------------------------------------------------------- reading

    def clean(self, spans: list) -> list:
        """``spans`` of the sequences after the profiled ones, where there
        are any."""
        late = [s for s in spans if s.sequence >= self.first_clean]
        return late or spans

    def device_ms_per_sequence(self, *names) -> list:
        """Each sequence's summed device ms over the calls of all ``names``;
        empty where one of them was never called."""
        if not all(self.records.get(n) for n in names):
            return []
        total = defaultdict(float)
        for n in names:
            for s in self.clean(self.records[n]):
                ms = s.device_ms()
                if ms is None:
                    return []
                total[s.sequence] += ms
        return [total[k] for k in sorted(total)]

    def host_s_per_sequence(self, *names, union: bool = False) -> list:
        """Each sequence's host seconds in the calls of ``names``: summed,
        or with ``union`` the time in which at least one ran (calls on
        several threads at once count once)."""
        spans = self.clean([s for n in names for s in self.records.get(n, [])])
        by_seq = defaultdict(list)
        for s in spans:
            by_seq[s.sequence].append((s.start, s.end))
        out = []
        for k in sorted(by_seq):
            iv = by_seq[k]
            out.append(union_seconds(iv) if union else sum(b - a for a, b in iv))
        return out


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


_MISSING = object()

__all__ = ["Spans", "Span", "union_seconds"]
