"""The device's busy time and breakdown from ``torch.profiler``.

A traced run profiles the first ``TRACE_SECONDS`` of its window (whole
sequences; the traffic kind's constant, or the whole window), and runs the rest
of the window without the profiler. From the profiler's
events this reads:

- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) over the traced window, and ``window_s``, the window's length on
  the host clock;
- ``device_ops``: the ten operations that took the device the most
  seconds, summed by name;
- ``idle_gaps``: the idle time between device operations, summed by what
  the host's main thread was doing at the gap's middle (the innermost
  profiler event there: a ``span:`` of the benchmark, an ``aten::`` op,
  or ``(outside any op)``), the ten largest.
"""

from __future__ import annotations

import time
from collections import defaultdict

#: the names of the benchmark's own record_function ranges
ANNOTATIONS = ("span:", "portbench.")


class Profiler:
    def __init__(self, cuda: bool, seconds=None):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.seconds = seconds
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None
        self.summary = None

    def start(self) -> None:
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.t1 is not None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof.profiler.kineto_results.events(),
                                 self.t1 - self.t0)


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_work(ev) -> bool:
    """A device event that occupies the card (a kernel, a copy, a set), not
    a synchronization record."""
    return "sync" not in ev.name().lower()


def _is_annotation(ev) -> bool:
    """A ``record_function`` range, which the profiler also draws on the
    device's timeline: no work of the card."""
    return ((hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
            or ev.name().startswith(ANNOTATIONS))


def merge(intervals):
    """Sorted, disjoint unions of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, window_s: float) -> dict:
    """busy_s, window_s and the breakdown from kineto events."""
    events = list(events)
    main = main_thread(events)
    dev = [ev for ev in events if _is_device(ev) and _is_work(ev)
           and not _is_annotation(ev)]
    host = [ev for ev in events
            if not _is_device(ev) and ev.start_thread_id() == main]
    by_name = defaultdict(float)
    for ev in dev:
        by_name[ev.name()] += ev.duration_ns() * 1e-9
    busy = merge((ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in dev)
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": window_s,
        "device_ops": top(by_name),
        "idle_gaps": top(name_gaps(gaps, host)),
    }


def main_thread(events):
    """The thread whose host events of the benchmark's spans (or, without
    spans, of any kind) took the most time: the thread that ran the
    sequences."""
    spent = defaultdict(int)
    for ev in events:
        if not _is_device(ev) and ev.name().startswith("span:"):
            spent[ev.start_thread_id()] += ev.duration_ns()
    if not spent:
        for ev in events:
            if not _is_device(ev):
                spent[ev.start_thread_id()] += ev.duration_ns()
    return max(spent, key=spent.get) if spent else None


def name_gaps(gaps, host) -> dict:
    """Seconds of the gaps summed by the innermost host event covering each
    gap's middle. Events of one thread nest: kept as a stack of open
    events, the innermost is on top."""
    out = defaultdict(float)
    evs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in host), key=lambda t: (t[0], -t[1]))
    stack, nxt = [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while nxt < len(evs) and evs[nxt][0] <= mid:
            while stack and stack[-1][1] <= evs[nxt][0]:
                stack.pop()
            stack.append(evs[nxt])
            nxt += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "(outside any op)"] += (b - a) * 1e-9
    return out


def idle_pct(run):
    """100 (1 - busy_s / window_s) of a traced run on the card; None
    elsewhere."""
    if not run.cuda or run.profile is None or run.profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])


def top(seconds_by_name: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(seconds_by_name.items(),
                                      key=lambda kv: -kv[1])[:n]]


__all__ = ["Profiler", "summarize", "merge", "name_gaps", "top", "idle_pct"]
