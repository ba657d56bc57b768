"""The ``linearfit`` traffic kind at a size the CPU runs in seconds: a tiny
configuration and its cell added as new files and entries to a copy of
the folder, as ``test_portbench_discovery.py`` adds its own, found
without an edit, run whole (traced and not), and its control, the fit
one precision step lower, failing where the program passes."""

import json
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "siril-0.9_tpu")]

import tiny  # noqa: E402
from portbench.core import spec  # noqa: E402
from portbench.core.check import verdict  # noqa: E402
from portbench.core.reference import Precision  # noqa: E402

CELL = "tiny_lf.linearfit"
CONFIG = dict(tiny.TINY, name="tiny_lf", frames=12, rejection="linearfit",
              sig=[2.0, 1.5], normalize="none",
              precision={"linearfit": {"correlation": "float32", "quality": "float32",
                                       "statistics": "float32", "ikss": "float64",
                                       "normalize": "float32"}})


def make_root(tmp: Path) -> Path:
    """``tiny.make_root``'s checkout with the configuration ``tiny_lf`` and
    its cell ``tiny_lf.linearfit`` added, reporting what the deep-sky
    linearfit cell reports."""
    root = tiny.make_root(tmp)
    (root / "portbench/configs/tiny_lf.json").write_text(json.dumps(CONFIG))
    (root / f"portbench/workloads/{CELL}.json").write_text(json.dumps(
        {"config": "tiny_lf", "traffic": "linearfit", "chips": 1,
         "limits": {"words_off": 0, "quality_gap": 1e-3}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_lf", "source": "a test size",
                             "file": "portbench/configs/tiny_lf.json",
                             "reduced": CONFIG["reduced"], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_lf", "traffic": "linearfit",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deepsky_mono_2k.linearfit" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_the_cell_is_found_with_its_pieces(tmp_path):
    root = make_root(tmp_path)
    cell = spec.cell(root, CELL)
    traffic = spec.traffic(root, cell.traffic)
    assert traffic.TRACE_SECONDS > 0 and traffic.SPANS[:4] == traffic.resident.SPANS
    per_layer = [m.name for m in cell.per_layer]
    assert {"reject_roofline_pct.linearfit", "linearfit_settle_ms"} <= set(per_layer)
    assert [m.name for m in cell.end_to_end] == ["frames_per_s", "sequence_ms_p95", "setup_s"]
    assert CELL not in [w["name"] for w in json.loads(
        (tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_linearfit_cell_runs_and_proves_correct(tmp_path, trace):
    root = make_root(tmp_path)
    code, result, err = tiny.run_cpu(
        root, ["--workload", CELL, "--seed", str(2**31 + 23), "--seconds", "0.5",
               "--trace", str(trace)])
    assert code == 0, err
    assert result["correct"] is True and result["failed"] == 0
    assert result["compared"]["words_off"]["value"] == 0
    if trace:
        # on the CPU the device metrics read nothing and are left out
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert not {"reject_roofline_pct.linearfit", "linearfit_settle_ms"} & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"frames_per_s", "sequence_ms_p95", "setup_s"}


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_the_control_fails_where_the_program_passes(tmp_path, seed):
    root = make_root(tmp_path)
    cell = spec.cell(root, CELL)
    traffic = spec.traffic(root, "linearfit")
    state = traffic.State(cell.config, cell.params, seed, "cpu")
    try:
        want = traffic.reference(state, Precision())
        got, _ = traffic.sequence(state, None)
        assert verdict(traffic.compare(got, want), cell.limits)[0]
        control = traffic.reference(state, Precision.below(cell.config["precision"]["linearfit"]))
        ok, rows = verdict(traffic.compare(control, want), cell.limits)
        assert not ok, rows
    finally:
        traffic.close(state)
