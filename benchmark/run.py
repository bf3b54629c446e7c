"""The benchmark of ``ecog2txt_tpu_torch`` on one NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell, its
configuration and traffic mix; ``benchmark/harness/registry.py`` says
which file each name is.  A run makes the weights and the corpus on the
card from ``--seed``, loads the program's kernels (building the missing
ones), drives the checked first steps and warms up the cell's shapes
(``setup_s``), measures ``--seconds`` on the host clock, with ``--trace
1`` traces a short window with ``torch.profiler``, then frees the
program's state and holds what it produced to the plain float32
reference (``benchmark/reference/``).  The numbers compared, each beside
its limit, are the last lines on standard error; the last line on
standard output is the result.  Without a CUDA card it prints no result
and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"  # fixed directories inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "ecog2txt_tpu")


def _prepare_environment() -> None:
    # one host thread for the program's CPU work: the window is paced by
    # one Python thread launching kernels, which idle OpenMP workers only
    # contend with
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process (top-level
    names compared whole: the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _overlay(base: dict, over: dict | None) -> dict:
    return {**base, **(over or {})}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None):
    """One run of ``workload``; returns ``(result, compared_lines)``.
    ``overrides`` replaces keys of the configuration's ``model`` and
    ``training`` and of the traffic (the tests' small sizes)."""
    import concurrent.futures as cf

    import torch

    from benchmark.harness import port, registry
    from benchmark.harness.context import Context
    from benchmark.harness.drivers import DRIVERS
    from benchmark.harness.judge import verdict
    from benchmark.harness.traffic import derive, make_corpus
    from benchmark.harness.weights import make_weights

    over = overrides or {}
    bench = registry.benchmark()
    cell = registry.workload(bench, workload)
    config = registry.config(bench, cell["config"])
    config = {**config, "model": _overlay(config["model"], over.get("model")),
              "training": _overlay(config["training"], over.get("training"))}
    traffic = _overlay(registry.traffic(cell["traffic"]), over.get("traffic"))
    limits = registry.limits(workload)
    device = torch.device(device)
    on_card = device.type == "cuda"

    marks = {"imports": time.perf_counter() - T_START}
    with cf.ThreadPoolExecutor(1) as pool:
        kernels = pool.submit(port.load_kernels) if on_card else None
        corpus = make_corpus(config["model"], traffic, seed, device)
        weights = make_weights(config["model"], derive(seed, "weights"), device)
        if kernels is not None:
            kernels.result()
    marks["data, weights, kernels"] = time.perf_counter() - T_START
    driver = DRIVERS[traffic["kind"]](config, traffic, corpus, weights, seed, device)
    driver.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    print("set-up to the end of: " + ", ".join(f"{k} {v:.3f} s" for k, v in marks.items())
          + f", checked steps and warm-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    window = driver.measure(seconds)
    traced = driver.trace(int(traffic["traced_units"])) if trace else None
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    ok, compared = verdict(driver.judge(), limits)

    ctx = Context(kind=traffic["kind"], model=config["model"], traffic=traffic,
                  setup_s=setup_s, window=window, trace=traced)
    metrics = {}
    for m in registry.metrics_for(bench, workload, per_layer=trace):
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and window["failed"] == 0), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = traced.breakdown()
    result["compared"] = compared
    lines = [f"compared {k} {c['value']!r} limit {c['limit']!r}" for k, c in compared.items()]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _prepare_environment()

    import torch

    from benchmark.harness import registry

    chips = int(registry.workload(registry.benchmark(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
