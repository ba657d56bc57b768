"""The control at a size a test run holds: the reference computed one
precision step below the one the configuration states for the cell's
path, put in the program's place, fails the cell's limits on every seed
tried, where the program passes them."""

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "siril-0.9_tpu")]

import tiny  # noqa: E402
from portbench.core import spec  # noqa: E402
from portbench.core.check import verdict  # noqa: E402
from portbench.core.reference import Precision  # noqa: E402


@pytest.mark.parametrize("seed", [31, 32, 33])
@pytest.mark.parametrize("kind", ["resident", "ser"])
def test_the_control_fails_where_the_program_passes(tmp_path, kind, seed):
    root = tiny.make_root(tmp_path)
    cell = spec.cell(root, f"tiny.{kind}")
    traffic = spec.traffic(root, kind)
    state = traffic.State(cell.config, cell.params, seed, "cpu")
    try:
        want = traffic.reference(state, Precision())
        got, _ = traffic.sequence(state, None)
        assert verdict(traffic.compare(got, want), cell.limits)[0]
        control = traffic.reference(state, Precision.below(cell.config["precision"][kind]))
        ok, rows = verdict(traffic.compare(control, want), cell.limits)
        assert not ok, rows
    finally:
        traffic.close(state)
