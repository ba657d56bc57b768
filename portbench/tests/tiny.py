"""A checkout of the benchmark at a size the CPU runs in seconds: a copy of
``portbench/`` and ``BENCHMARK.json`` in a temporary directory, with a
tiny configuration and a cell of it for each traffic kind added as files
and entries, as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "a test size", "frames": 8, "height": 96,
    "width": 128, "drift": 6, "points": 120, "outlier_every": 10000,
    "selection": 32, "method": "mean", "rejection": "sigma", "sig": [3.0, 3.0],
    "normalize": "additive_scaling",
    "precision": {kind: {"correlation": "float32", "quality": q,
                         "statistics": "float32", "ikss": "float64",
                         "normalize": "float32"}
                  for kind, q in (("resident", "float32"), ("ser", "float64"))},
    "reduced": ["frames", "height", "width"], "assumed": ["a test size"],
}
LIMITS = {"resident": {"words_off": 0, "quality_gap": 1e-3},
          "ser": {"words_off": 0, "rejections_off": 0, "quality_gap": 1e-6}}


#: the metrics of the ``ser`` kind, entered as a cell of that kind would
#: enter them where BENCHMARK.json has none yet
SER_METRICS = {
    "end_to_end": [{"name": "file_frames_per_s", "unit": "frames/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": n, "unit": u, "better": "lower", "source": src, "layer": layer,
                   "moves": "file_frames_per_s"}
                  for n, u, src, layer in (
                      ("file_register_s", "s", "program_span", "registration driver"),
                      ("normalize_s", "s", "program_span", "normalization"),
                      ("read_s", "s", "program_span", "file read"),
                      ("device_idle_pct.file", "%", "device_trace", "device"))],
}
RATE_METRICS = {"frames_per_s": ("frames_per_s", "sequence_ms_p95"),
                "file_frames_per_s": ("file_frames_per_s",)}


def make_root(tmp: Path, rejection: str = "sigma", metric_source: str = None) -> Path:
    """A checkout under ``tmp`` with the cells ``tiny.resident`` and
    ``tiny.ser`` (and, given its source, the per-layer metric
    ``tiny_metric`` of ``tiny.resident``) added."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    config = dict(TINY, rejection=rejection)
    (root / "portbench/configs/tiny.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "tiny", "source": "a test size",
                             "file": "portbench/configs/tiny.json",
                             "reduced": TINY["reduced"], "why": "tests"})
    for kind in ("resident", "ser"):
        name = f"tiny.{kind}"
        (root / f"portbench/workloads/{name}.json").write_text(json.dumps(
            {"config": "tiny", "traffic": kind, "chips": 1,
             "limits": LIMITS[kind]}))
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": kind,
                                   "chips": 1, "why": "tests"})
        # the tiny cells report what the metrics of their kind's rate do
        rate = "frames_per_s" if kind == "resident" else "file_frames_per_s"
        for group, entries in SER_METRICS.items():
            have = {m["name"] for m in bench[group]}
            bench[group] += [dict(m, workloads=[]) for m in entries if m["name"] not in have]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in RATE_METRICS[rate] or m.get("moves") == rate:
                m.setdefault("workloads", []).append(name)
    if metric_source is not None:
        (root / "portbench/metrics/tiny_metric.py").write_text(metric_source)
        bench["per_layer"].append({
            "name": "tiny_metric", "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "registration",
            "moves": "frames_per_s", "workloads": ["tiny.resident"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_cpu(root: Path, argv, patch: str = "", timeout: int = 300):
    """Run ``portbench/run.py``'s main in a fresh interpreter on the CPU
    (the look for a card skipped), after the Python statements ``patch``.
    Returns (exit code, the result line or None, standard error)."""
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'siril-0.9_tpu')!r}]",
        patch,
        "from portbench import run",
        f"sys.exit(run.main({list(argv)!r}, root={str(root)!r}, device='cpu'))",
    ])
    env = dict(os.environ, TMPDIR=str(root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr


__all__ = ["make_root", "run_cpu", "TINY", "REPO"]
