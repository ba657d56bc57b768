"""Whole runs of a tiny cell of each traffic kind on the CPU (the look for
a card skipped), and the two ways a run ends without a result: no card,
and a checkout without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[2])]

import tiny  # noqa: E402

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("kind", ["resident", "ser"])
def test_a_tiny_cell_runs_and_proves_correct(tmp_path, kind, trace):
    root = tiny.make_root(tmp_path, rejection="winsorized" if kind == "ser" else "sigma")
    code, result, err = tiny.run_cpu(
        root, ["--workload", f"tiny.{kind}", "--seed", str(2**31 + 11),
               "--seconds", "0.5", "--trace", str(trace)])
    assert code == 0, err
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in result["compared"].values())
    assert err.strip().splitlines()[-1].startswith("compared ")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        # on the CPU the device metrics read nothing; the host spans do
        if kind == "ser":
            assert {"file_register_s", "normalize_s", "read_s"} <= set(result["metrics"])
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if f"tiny.{kind}" in m.get("workloads", [f"tiny.{kind}"])}
        assert set(result["metrics"]) == want
        for m in result["metrics"].values():
            assert m["value"] > 0


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(tiny.REPO / "portbench/run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(tiny.REPO / "portbench", bare / "portbench")
    shutil.copy(tiny.REPO / "BENCHMARK.json", bare / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(bare / "portbench/run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=bare, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
