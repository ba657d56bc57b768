#!/usr/bin/env python3
"""The readings that the limits of a cell's correctness check are set from,
on the card, at the cell's own size:

- the program's (the lower reading): each of ``--seeds`` makes the cell's
  inputs, runs one sequence of the timed path, and compares it with the
  plain reference, as a run of ``run.py`` does after its window;
- the control's (the upper reading): each of ``--control-seeds`` puts the
  reference, computed one precision step below the one the configuration
  states for the cell's path (``Precision.below``), in the program's
  place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

Prints one JSON line a seed and side, also written to
``chiprun_out/control_<cell>.jsonl``. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO / "siril-0.9_tpu"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.core import spec  # noqa: E402
from portbench.core.check import rows_off  # noqa: E402
from portbench.core.reference import Precision  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell, traffic, seed: int, device, control: bool) -> dict:
    import torch

    t = time.perf_counter()
    state = traffic.State(cell.config, cell.params, seed, device)
    try:
        ref = traffic.reference(state, Precision())
        if control:
            got = traffic.reference(state, Precision.below(
                cell.config["precision"][cell.traffic]))
        else:
            got, _ = traffic.sequence(state, None)
        numbers = traffic.compare(got, ref)
        return {"seed": seed, "side": "control" if control else "program",
                "numbers": numbers, "truth_off": rows_off(state.truth, ref[1]),
                "seconds": time.perf_counter() - t}
    finally:
        traffic.close(state)
        del state
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    cell = spec.cell(REPO, args.workload)
    traffic = spec.traffic(REPO, cell.traffic)
    device = torch.device(args.device)
    out = REPO / "chiprun_out" / f"control_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    with open(out, "a") as f:
        for control, group in ((False, seeds(args.seeds)),
                               (True, seeds(args.control_seeds))):
            for seed in group:
                line = json.dumps(readings(cell, traffic, seed, device, control))
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
