"""siriltpu_torch.utils.timing, the port's tracing: spans off and on,
their nesting across threads, counters, the shared clock with
torch.profiler, and the spans and counters the program's stages emit.
CPU only; a fake CUDA event shows that a span never waits for the card."""

import math
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from siriltpu_torch.pipelines import register_stack as trs  # noqa: E402
from siriltpu_torch.utils import timing  # noqa: E402
from siriltpu_torch.utils.timing import (collect, count, counters,  # noqa: E402
                                         current, span)

STAGES = ("register_and_stack", "register.shifts", "register.quality",
          "align.shift_read", "align.copy", "stack.reject", "result.to_host")


@pytest.fixture(autouse=True)
def tracing_off():
    timing.disable()
    collect()
    yield
    timing.disable()
    collect()


def _self_ns(parent, spans) -> int:
    """A span's host time outside its children: its length less the
    union of its children's intervals, each cut to its own."""
    cut = sorted((max(s.start_ns, parent.start_ns), min(s.end_ns, parent.end_ns))
                 for s in spans if s.parent == parent.id)
    inside, hi = 0, parent.start_ns
    for a, b in cut:
        a = max(a, hi)
        if b > a:
            inside, hi = inside + b - a, b
    return parent.end_ns - parent.start_ns - inside


def _sleep_ms(ms: float) -> None:
    end = time.perf_counter() + ms / 1e3
    while time.perf_counter() < end:
        pass


def test_off_is_a_noop(monkeypatch):
    """Off, a span is one shared object: it reads no clock, opens no
    profiler range, makes no CUDA event and keeps nothing."""
    def boom(*a, **k):
        raise AssertionError("the off path did work")

    monkeypatch.setattr(timing.time, "perf_counter_ns", boom)
    monkeypatch.setattr(timing.time, "time_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    first = span("a", device=torch.device("cuda"), F=3)
    assert span("b") is first and span("c", parent=None) is first
    with first as s:
        with span("d"):
            assert current() is None
    assert s is first
    assert collect() == []
    assert not timing._on


def test_nesting_parent_root_and_self_time():
    timing.enable()
    with span("outer", kind="x") as outer:
        with span("a") as a:
            _sleep_ms(2)
        with span("b") as b:
            with span("c") as c:
                _sleep_ms(1)
            assert current() is b
    with span("next") as nxt:
        pass
    spans = collect()
    assert [s.name for s in spans] == ["a", "c", "b", "outer", "next"]
    assert collect() == []
    assert outer.attrs == {"kind": "x"} and outer.parent is None
    assert (a.parent, b.parent, c.parent) == (outer.id, outer.id, b.id)
    assert {s.root for s in (outer, a, b, c)} == {outer.id}
    assert nxt.root == nxt.id and nxt.parent is None
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
    # children lie inside their parent, one after another
    assert outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= outer.end_ns
    assert _self_ns(outer, spans) == (outer.end_ns - outer.start_ns
                                      - (a.end_ns - a.start_ns)
                                      - (b.end_ns - b.start_ns))
    assert _self_ns(b, spans) == b.end_ns - b.start_ns - (c.end_ns - c.start_ns)
    assert _self_ns(a, spans) == a.end_ns - a.start_ns
    assert timing.totals(spans)["a"] == pytest.approx(a.seconds)


def test_self_time_takes_the_union_of_children_on_two_threads():
    """A worker's span, adopted by the call it works for, overlaps a
    child on the main thread: the parent's self time subtracts their
    union, not their sum."""
    timing.enable()
    with span("call") as call:
        owner = current()

        def work():
            with span("worker", parent=owner):
                _sleep_ms(20)

        t = threading.Thread(target=work)
        t.start()
        with span("main"):
            _sleep_ms(10)
        t.join(timeout=10)
        assert not t.is_alive()
    spans = collect()
    by = {s.name: s for s in spans}
    worker, main = by["worker"], by["main"]
    assert worker.parent == call.id and worker.root == call.id
    assert worker.thread != call.thread == main.thread
    lo = min(worker.start_ns, main.start_ns)
    hi = max(worker.end_ns, main.end_ns)
    union = hi - lo if min(worker.end_ns, main.end_ns) >= max(
        worker.start_ns, main.start_ns) else (worker.end_ns - worker.start_ns
                                              + main.end_ns - main.start_ns)
    assert call.start_ns <= min(worker.start_ns, main.start_ns)
    assert max(worker.end_ns, main.end_ns) <= call.end_ns
    assert _self_ns(call, spans) == call.end_ns - call.start_ns - union


def test_self_time_cuts_children_to_the_parent():
    """A worker's span may end after the call it works for has closed:
    it keeps the call as parent and root, and only the part inside the
    call counts against the call's own time."""
    timing.enable()
    opened, go = threading.Event(), threading.Event()
    with span("call") as call:
        owner = current()

        def work():
            with span("worker", parent=owner):
                opened.set()
                go.wait(10)

        t = threading.Thread(target=work)
        t.start()
        assert opened.wait(10)
        _sleep_ms(2)
    go.set()
    t.join(timeout=10)
    assert not t.is_alive()
    spans = collect()
    worker = next(s for s in spans if s.name == "worker")
    assert (worker.parent, worker.root) == (call.id, call.id)
    assert worker.end_ns > call.end_ns
    assert _self_ns(call, spans) == (
        max(worker.start_ns, call.start_ns) - call.start_ns)


def test_a_thread_has_its_own_stack():
    timing.enable()
    seen = {}

    def work():
        seen["before"] = current()
        with span("t1") as t1:
            with span("t2") as t2:
                seen["inner"] = current()
        seen["spans"] = (t1, t2)

    with span("main") as m:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert current() is m
        with span("after") as after:
            pass
    t1, t2 = seen["spans"]
    assert seen["before"] is None and seen["inner"] is t2
    assert t1.parent is None and t1.root == t1.id
    assert t2.parent == t1.id and t2.root == t1.id
    assert t1.thread == t2.thread != m.thread
    assert after.parent == m.id
    assert len(collect()) == 4


def test_counters():
    timing.reset()
    count("x")
    count("x", 4)
    count("y", 2.5)
    got = counters()
    assert got == {"x": 5, "y": 2.5}
    got["x"] = 0
    assert counters()["x"] == 5
    timing.enable()
    with span("kept"):
        count("x")
    timing.reset()
    assert counters() == {} and collect() == []


class _Ops(TorchDispatchMode):
    """The aten operators dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("aten."):
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("rejection", ["sigma", "winsorized"])
def test_degenerate_counter_only_while_tracing(rejection):
    """``reject.degenerate.<rejection>`` counts the pixels the window form
    flagged degenerate (at F = 4 every one) as one sum a call, kept as a
    tensor until ``counters()`` reads it. Off, nothing is counted and the
    stack runs the same operators less that sum."""
    from siriltpu_torch.ops.cuda import reject_stack as rs

    name = f"reject.degenerate.{rejection}"
    vals = torch.from_numpy(np.random.default_rng(4).integers(
        0, 65536, (4, 50)).astype(np.int32)).to(torch.int16).view(torch.uint16)
    timing.reset()
    with _Ops() as off:
        rs.reject_stack(vals, rejection, 2.0, 2.0)
    assert name not in counters()
    timing.enable()
    with _Ops() as on:
        rs.reject_stack(vals, rejection, 2.0, 2.0)
    rs.reject_stack(vals, rejection, 2.0, 2.0)
    timing.disable()
    assert on.ops - off.ops == Counter({"aten.sum.default": 1})
    assert not off.ops - on.ops
    degen = rs.reject_plain(vals, rejection, 2.0, 2.0)[1]
    assert int(degen.sum()) == 50
    got = counters()[name]
    assert type(got) is int and got == 2 * 50


def test_spans_lie_on_the_profiler_clock():
    """Each span's torch.profiler range starts within 1 ms of the span's
    own stamp: the two share one axis."""
    from torch.profiler import ProfilerActivity, profile

    timing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("probe.outer"):
            torch.ones(64).sum()
            with span("probe.inner"):
                _sleep_ms(3)
    spans = collect()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert set(events) == {"probe.outer", "probe.inner"}
    for s in spans:
        assert abs(events[s.name].start_ns() - s.start_ns) < 1_000_000, s
        assert abs(events[s.name].duration_ns() - (s.end_ns - s.start_ns)) < 1_000_000


def test_a_span_never_synchronizes(monkeypatch):
    """On a CUDA device a span records two events on the device's current
    stream and waits for nothing; collect() reads their time."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream=None):
            log.append(("record", stream))

        def synchronize(self):
            log.append("synchronize")

        def elapsed_time(self, end):
            log.append("elapsed")
            return 1.5

    def no_sync(*a, **k):
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "s0")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timing.enable()
    with span("dev", device=torch.device("cuda")):
        pass
    with span("host"):
        pass
    assert log == [("record", "s0"), ("record", "s0")]
    dev, host = collect()
    assert log[2:] == ["synchronize", "elapsed"]
    assert dev.device_ms == 1.5 and host.device_ms is None
    timing.enable(device_time=False)
    with span("dev", device=torch.device("cuda")):
        pass
    assert len(log) == 4 and collect()[0].device_ms is None


@pytest.fixture(scope="module")
def bench():
    return trs.RegisterStackBench(size=128, nframes=8, device="cpu")


def test_register_and_stack_emits_its_stages(bench):
    """One call: the root and each stage once, every stage a child of
    the root, each with its attributes."""
    frames = bench.frames()
    timing.enable()
    stacked, shifts, quality = trs.register_and_stack(
        frames, sel=bench.sel, rejection="winsorized")
    spans = collect()
    assert sorted(s.name for s in spans) == sorted(STAGES)
    by = {s.name: s for s in spans}
    root = by["register_and_stack"]
    assert root.parent is None
    assert root.attrs == {"F": 8, "H": 128, "W": 128, "rejection": "winsorized"}
    for name in STAGES[1:]:
        assert by[name].parent == root.id and by[name].root == root.id, name
    assert by["align.copy"].attrs == {"form": "slice"}
    assert by["stack.reject"].attrs == {"shape": (8, 128 * 128),
                                        "rejection": "winsorized",
                                        "form": "plain"}
    nbytes = stacked.nbytes + 8 * 8 + quality.nbytes
    assert by["result.to_host"].attrs == {"bytes": nbytes}
    np.testing.assert_array_equal(shifts, -bench.shifts)
    # with the results left on the device there is no copy to the host
    timing.enable()
    trs.register_and_stack(frames, sel=bench.sel, rejection="winsorized",
                           return_device=True, with_quality=False)
    names = sorted(s.name for s in collect())
    assert names == sorted(set(STAGES) - {"register.quality", "result.to_host"})


def test_align_far_shift_is_a_slice_span():
    """A shift past the frame takes the CPU's one route: the host read of
    the shifts, then the slice copy."""
    frames = torch.zeros((3, 16, 16), dtype=torch.uint16)
    sx = torch.tensor([0, 100, -3], dtype=torch.int32)
    timing.enable()
    trs.align_frames_auto(frames, sx, sx)
    spans = collect()
    assert [(s.name, s.attrs) for s in spans] == [
        ("align.shift_read", {}), ("align.copy", {"form": "slice"})]


@pytest.mark.parametrize("stream", [True, False])
def test_stack_sequence_spans_and_blocks(tmp_path, stream):
    """The streaming stack emits one ``stack.block`` (and one read and
    one wait) a block that ``stack.blocks`` counts, its reads on the
    reader thread under the call's root; read whole, it counts none."""
    from siriltpu_torch.core.frame import Frame
    from siriltpu_torch.io.ser import SER_RGB, SerFile
    from siriltpu_torch.io.sequence import ser_sequence
    from siriltpu_torch.stacking import api as tapi

    f, h, w, rows = 6, 30, 20, 7
    rng = np.random.default_rng(5)
    path = str(tmp_path / "cap.ser")
    ser = SerFile.create(path, w, h, color_id=SER_RGB)
    for _ in range(f):
        ser.write_frame(Frame(rng.integers(0, 4000, (3, h, w)).astype(np.uint16)))
    ser.write_and_close()
    seq = ser_sequence(path)
    for r, (sx, sy) in zip(seq.ensure_regparam(0), rng.integers(-3, 4, (f, 2))):
        r.shiftx, r.shifty = int(sx), int(sy)
    before = counters().get("stack.blocks", 0)
    timing.enable()
    res = tapi.stack_sequence(seq, device="cpu", method="mean",
                              rejection="sigma", normalize="additive_scaling",
                              block_rows=rows, stream=stream)
    spans = collect()
    blocks = counters().get("stack.blocks", 0) - before
    names = [s.name for s in spans]
    root = next(s for s in spans if s.name == "stack_sequence")
    assert res.data.shape == (3, h, w)
    assert {s.root for s in spans} == {root.id}
    assert names.count("stack.normalize") == 1
    assert names.count("result.to_host") == 1
    if stream:
        assert blocks == 3 * math.ceil(h / rows)
        assert names.count("stack.block") == blocks
        assert names.count("stack.reject") == blocks
        assert names.count("stack.wait") == blocks
        reads = [s for s in spans if s.name == "stack.read_block"]
        assert len(reads) == blocks
        assert all(s.parent == root.id and s.thread != root.thread for s in reads)
        assert "stack.read" not in names and "stack_frames" not in names
    else:
        assert blocks == 0
        assert names.count("stack.read") == 1 and names.count("stack_frames") == 1
        assert "stack.read_block" not in names and "stack.wait" not in names
