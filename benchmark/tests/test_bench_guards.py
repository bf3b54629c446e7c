"""Guards of the benchmark: what its modules import, that new cells, mixes
and metrics are found by name from new files alone, and that a run without
a card or without the program prints no result."""

from __future__ import annotations

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import registry

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "ecog2txt_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _modules(folder: Path) -> list[Path]:
    return sorted(folder.rglob("*.py"))


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): sorted(_imports(p) & FORBIDDEN) for p in _modules(BENCH)}
    assert {k: v for k, v in found.items() if v} == {}
    assert len(found) > 20  # the walk saw the harness, the metrics and the tests


def test_the_top_level_name_is_compared_whole():
    """The port's name begins with the JAX package's and is allowed."""
    harness = _imports(BENCH / "harness" / "port.py")
    assert "ecog2txt_tpu_torch" in harness and not harness & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules(BENCH / "reference"):
        assert _imports(path) <= {"__future__", "contextlib", "math", "torch"}, path


def _digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_mix_and_metric_need_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/bilstm-makin2020.json").read_text())
    config["name"] = "bilstm-wide"
    config["model"]["rnn_sizes"] = [512, 512, 512]
    (root / "benchmark/configs/bilstm-wide.json").write_text(json.dumps(config))
    mix = json.loads((root / "benchmark/traffic/train-b256.json").read_text())
    (root / "benchmark/traffic/train-b128.json").write_text(json.dumps({**mix, "batch": 128}))
    (root / "benchmark/limits/bilstm-wide.train-b128.json").write_text(json.dumps({"loss": 1}))
    (root / "benchmark/metrics/launches.train.py").write_text(
        "def read(ctx):\n    return 7.0 if ctx.kind == 'train' else None\n")
    bench["configs"].append({"name": "bilstm-wide", "source": "https://example.org",
                             "file": "benchmark/configs/bilstm-wide.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "bilstm-wide.train-b128", "config": "bilstm-wide",
                               "traffic": "train-b128", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "launches.train", "unit": "launches", "better": "lower",
                               "source": "program_counter", "layer": "kernels (csrc/)",
                               "moves": "train_sentences_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_sentences_per_s":
            m["workloads"].append("bilstm-wide.train-b128")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    changed = [k for k in before if before[k] != after[k]]
    assert changed == ["BENCHMARK.json"]  # only its entries grew

    loaded = registry.benchmark(root)
    cell = registry.workload(loaded, "bilstm-wide.train-b128")
    assert registry.config(loaded, cell["config"], root)["model"]["rnn_sizes"] == [512] * 3
    assert registry.traffic(cell["traffic"], root / "benchmark")["batch"] == 128
    assert registry.limits(cell["name"], root / "benchmark") == {"loss": 1}
    names = [m["name"] for m in registry.metrics_for(loaded, cell["name"], per_layer=True)]
    assert "launches.train" in names and "device_idle_pct.train" not in names
    read = registry.reader("launches.train", root / "benchmark")
    assert read(type("Ctx", (), {"kind": "train"})()) == 7.0
    ends = [m["name"] for m in registry.metrics_for(loaded, cell["name"], per_layer=False)]
    assert ends == ["train_sentences_per_s", "setup_s"]


def test_every_metric_and_cell_has_its_files():
    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(registry.reader(m["name"]))
    for w in bench["workloads"]:
        registry.config(bench, w["config"])
        assert registry.traffic(w["traffic"])["kind"] in ("train", "assess")
        assert registry.limits(w["name"])


def _run(cwd: Path, *extra) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bilstm-makin2020.train-b256",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would not stop at its check")


def test_without_a_card_no_result_and_a_nonzero_exit(no_card):
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_no_result_and_a_nonzero_exit(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
