#!/usr/bin/env python3
"""Run one cell of the benchmark of siriltpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (importing, the library loaded or built into the program's
``_build/``, the inputs made on the card from the seed, the warm-up) is
timed from the start of this process to the first timed sequence. The
window then runs whole sequences in a closed loop for ``--seconds``; with
``--trace 1`` the benchmark's spans wrap the program's stages and
``torch.profiler`` watches the device. Once the window has closed the
peak memory is read, a sequence sampled from the seed is compared with
the plain reference, and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``, each
number compared beside its limit (also the last lines of standard error).

A run that finds no card, or fewer than the cell asks for, fails and
prints no result; so does one that finds JAX or the JAX package loaded
once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO / "siril-0.9_tpu"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.core import spec  # noqa: E402
from portbench.core.check import rows_off, verdict  # noqa: E402
from portbench.core.guard import forbidden_modules  # noqa: E402
from portbench.core.window import Reservoir, closed_loop, percentile  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*lines) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def main(argv=None, *, root=None, device=None) -> int:
    """One run. ``root`` is the checkout that holds ``BENCHMARK.json`` and
    ``portbench/`` (this one by default). ``device`` None looks for the
    card the cell needs; tests pass ``"cpu"`` to drive the rest of a run
    without one."""
    args = parse(argv)
    root = Path(root) if root is not None else REPO
    try:
        cell = spec.cell(root, args.workload)
    except (KeyError, ValueError, FileNotFoundError) as e:
        say(f"portbench: {e}")
        return 2
    import torch

    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            say(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
                f"this machine has {have}")
            return 3
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
    else:
        device = torch.device(device)
        kind = str(device)
    cuda = device.type == "cuda"
    try:
        import siriltpu_torch  # noqa: F401
    except ImportError as e:
        say(f"portbench: the program is not in this checkout ({e})")
        return 2

    from portbench.core.reference import Precision
    from portbench.core.spans import Spans
    from portbench.core.trace import Profiler

    traffic = spec.traffic(root, cell.traffic)
    state = traffic.setup(cell.config, cell.params, args.seed, device)
    try:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - T0

        spans = prof = None
        if args.trace:
            spans = Spans(cuda)
            for module, attr, name, device_time in traffic.SPANS:
                spans.wrap(module, attr, name, device_time)
            prof = Profiler(cuda, traffic.TRACE_SECONDS)
        sample = Reservoir(random.Random(args.seed))

        def call():
            if spans is None:
                return traffic.sequence(state, None)
            spans.sequence += 1
            with torch.profiler.record_function("portbench.sequence"):
                return traffic.sequence(state, spans)

        if prof is None:
            window = closed_loop(call, args.seconds, keep=sample)
        else:
            # the profiler watches the first TRACE_SECONDS (or all) of the
            # window; the spans read the sequences after it, free of its
            # overhead, where there are any
            traced = min(prof.seconds or args.seconds, args.seconds)
            prof.start()
            try:
                window = closed_loop(call, traced, keep=sample)
            finally:
                prof.stop()
                spans.first_clean = spans.sequence + 1
            if args.seconds > traced:
                clean = closed_loop(call, args.seconds - traced,
                                    keep=lambda i, r: sample(i + len(window.sequences), r))
                window.sequences += clean.sequences
            spans.restore()
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
        else:
            peak = 0

        run = SimpleNamespace(cell=cell, config=cell.config, window=window,
                              spans=spans, cuda=cuda, card=kind, setup_s=setup_s,
                              profile=prof.summary if prof else None)
        metrics = {}
        for m in (cell.per_layer if args.trace else cell.end_to_end):
            value = spec.metric(root, m.name).read(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}

        # the check: the program's state is dropped, then the reference runs
        got = sample.result
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        want = traffic.reference(state, Precision())
        check_s = time.perf_counter() - t
        correct, rows = verdict(traffic.compare(got, want), cell.limits)
        truth = rows_off(state.truth, want[1])
    finally:
        traffic.close(state)

    bad = forbidden_modules()
    if bad:
        say(f"portbench: the run loaded {', '.join(bad)}: no result")
        return 4
    durations = window.durations_ms()
    say(f"portbench: {args.workload} seed {args.seed} on {kind}: set-up "
        f"{setup_s:.3f} s; window {window.seconds:.3f} s, "
        f"{len(durations)} sequences of {window.sequences[0][2]} frames, "
        f"median {percentile(durations, 50):.3f} ms, p95 "
        f"{percentile(durations, 95):.3f} ms; peak {peak} bytes",
        f"portbench: compared sequence {sample.index} of the window with the "
        f"reference ({check_s:.3f} s); the reference's shifts undo the "
        f"generated drift in all but {truth} frames",
        *(f"compared {name} {number} limit {limit}" for name, number, limit in rows))
    result = {
        "correct": correct,
        "attempted": len(window.sequences),
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type, "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if prof:
        result["device"].update(busy_s=prof.summary["busy_s"],
                                window_s=prof.summary["window_s"])
        result["breakdown"] = {k: prof.summary[k] for k in ("device_ops", "idle_gaps")}
    result["compared"] = {name: {"value": number, "limit": limit}
                          for name, number, limit in rows}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
