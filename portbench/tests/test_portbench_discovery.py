"""Discovery by name: every cell, configuration, traffic kind and metric of
BENCHMARK.json is found from its file, BENCHMARK.json keeps to the
benchmark's contract, and a configuration, cells and a per-layer metric
added as new files in a copy of the folder are found without an edit."""

import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2])]

import tiny  # noqa: E402
from portbench.core import spec  # noqa: E402

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TRAFFIC_API = ("SPANS", "State", "setup", "sequence", "reference", "compare", "close")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_pieces(cell):
    c = spec.cell(REPO, cell)
    assert c.chips == 1
    traffic = spec.traffic(REPO, c.traffic)
    assert all(hasattr(traffic, k) for k in TRAFFIC_API)
    assert c.traffic in c.config["precision"]
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric(REPO, m.name).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_modules_declare_what_benchmark_json_says(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = spec.metric(REPO, metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    e2e = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    # every cell the metric is read in reports the metric it moves
    assert set(entry["workloads"]) <= set(e2e.get("workloads", entry["workloads"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert (REPO / BENCH["command"][1]).is_file()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert spec.load_json(REPO / c["file"])["reduced"] == c["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_files_added_to_a_copy_are_found_without_an_edit(tmp_path):
    source = ('LAYER, UNIT, MOVES = "registration", "ms", "frames_per_s"\n\n'
              'def read(run):\n    return 1.5 * run.window.frames\n')
    root = tiny.make_root(tmp_path, metric_source=source)
    for p in (REPO / "portbench").rglob("*"):
        if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts:
            rel = p.relative_to(REPO)
            assert (root / rel).read_bytes() == p.read_bytes(), rel
    cell = spec.cell(root, "tiny.resident")
    assert cell.config["frames"] == tiny.TINY["frames"]
    assert "tiny_metric" in [m.name for m in cell.per_layer]
    assert "tiny_metric" not in [m.name for m in spec.cell(root, "tiny.ser").per_layer]
    run = SimpleNamespace(window=SimpleNamespace(frames=8))
    assert spec.metric(root, "tiny_metric").read(run) == 12.0
    with pytest.raises(KeyError):
        spec.cell(root, "tiny.nothing")
