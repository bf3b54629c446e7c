"""From a name in ``BENCHMARK.json`` to the file that defines it.

* a configuration: the ``file`` its entry in ``configs`` names
  (``benchmark/configs/<name>.json``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a metric, end-to-end or per-layer: ``benchmark/metrics/<name>.py``, the
  name whole, dots included (``device_idle_pct.train`` is
  ``metrics/device_idle_pct.train.py``), loaded by its path.  It defines
  ``read(ctx)``, which returns the metric's value or None where it finds
  nothing to read (the metric is then left out of the line).

So a new cell, mix or metric is new files and new entries, and no file
that is already there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def limits(workload_name: str, bench_dir: Path = BENCH) -> dict:
    return _json(bench_dir / "limits" / f"{workload_name}.json")


def reader(name: str, bench_dir: Path = BENCH):
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + name.replace(".", "__").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, workload_name: str, per_layer: bool) -> list[dict]:
    """The metrics a run of ``workload_name`` reports: its end-to-end
    metrics (``--trace 0``) or its per-layer metrics (``--trace 1``).  A
    metric without ``workloads`` applies to every cell; a per-layer one
    then to every cell that reports the end-to-end metric it moves."""
    def applies(m):
        return workload_name in m["workloads"] if "workloads" in m else True

    ends = [m for m in bench["end_to_end"] if applies(m)]
    if not per_layer:
        return ends
    reported = {m["name"] for m in ends}
    return [m for m in bench["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
