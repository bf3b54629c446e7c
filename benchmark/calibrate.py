"""Readings that the correctness limits of a cell are set from (not run by
the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]

For each seed, on the card, at the cell's own sizes: the program's
numbers (a sound run's set-up and checked steps, or a short run of
assessment calls) and the numbers of the control (the reference in float8
e4m3 in the program's place) and of the planted faults (training: half of
the batch left out, the mean over the rest; assessment: a token altered
where it is produced).  A state left unchanged reads 1 by the training
measure and needs no run.  One JSON line a seed; the lower reading of a
number is the largest over sound runs, the upper the smallest over the
control and the faults that fail it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

ASSESS_CALLS = 3


def _set_up(workload: str, seed: int, device, overrides: dict | None = None):
    """A run's set-up without its window: the driver after ``setup``."""
    import torch

    from benchmark.harness import port, registry
    from benchmark.harness.drivers import DRIVERS
    from benchmark.harness.traffic import derive, make_corpus
    from benchmark.harness.weights import make_weights

    over = overrides or {}
    bench = registry.benchmark()
    cell = registry.workload(bench, workload)
    config = registry.config(bench, cell["config"])
    config = {**config, "model": {**config["model"], **over.get("model", {})}}
    traffic = {**registry.traffic(cell["traffic"]), **over.get("traffic", {})}
    device = torch.device(device)
    if device.type == "cuda":
        port.load_kernels()
    corpus = make_corpus(config["model"], traffic, seed, device)
    weights = make_weights(config["model"], derive(seed, "weights"), device)
    driver = DRIVERS[traffic["kind"]](config, traffic, corpus, weights, seed, device)
    driver.setup()
    return driver, config, traffic


def _train_leaves(got: dict, want: dict, leaves0: list) -> dict:
    """Per-leaf readings behind the training numbers, for a look into a
    reading."""
    from benchmark.harness.judge import leaf_readings

    return {k: v.tolist() for k, v in leaf_readings(got, want, leaves0).items()}


def _as_got(want: dict) -> dict:
    """A reference's outputs in the shape of the program's (a control or a
    planted fault put in the program's place)."""
    return {"loss1": want["losses"][0], "parts1": want["parts"][0], "grads1": want["grads1"],
            "loss": float(sum(want["losses"][1:]) / len(want["losses"][1:])),
            "params": want["params"], "ema": want["ema"]}


def readings(workload: str, seed: int, device="cuda", overrides: dict | None = None,
             control: bool = True) -> dict:
    from benchmark.harness.judge import kept_leaves, train_numbers
    from benchmark.reference import seq2seq as ref

    driver, config, traffic = _set_up(workload, seed, device, overrides)
    out = {"seed": seed}
    if traffic["kind"] == "assess":
        for _ in range(ASSESS_CALLS):
            driver.tokens.append(driver._call())
        driver.release()
        out["program"] = driver.judge()
        if not control:
            return out
        out["control"] = driver.judge("fp8")
        V = int(config["model"]["vocab_size"])
        altered = driver.tokens[-1].copy()
        altered[:, 0] = (altered[:, 0] + V // 2) % V
        driver.tokens = [altered]
        out["fault_token_altered"] = driver.judge()
        return out
    driver.release()
    got = driver.outputs()
    steps = driver.reference_steps()
    want = driver.reference(steps)
    leaves0 = ref.leaves(driver.weights0)
    out["names"], out["kept"] = ref.leaf_paths(driver.weights0), kept_leaves(want).tolist()
    witness = driver.reference(steps, "bfloat16")  # its first step is the judge's witness
    out["program"] = train_numbers(got, want, leaves0, witness)
    out["program_leaves"] = _train_leaves(got, want, leaves0)
    sides = {"witness_bfloat16": witness}
    if control:
        sides["control"] = driver.reference(steps, "fp8")
        half = [({k: (v if k == "subject_idx" else v[: len(v) // 2]) for k, v in batch.items()},
                 [(kind, m[:, : m.shape[1] // 2] if kind == "ff" else m[: len(m) // 2])
                  for kind, m in masks])
                for batch, masks in steps]
        sides["fault_half_batch"] = driver.reference(half)
    for side, other in sides.items():
        out[side] = train_numbers(_as_got(other), want, leaves0, witness)
        out[f"{side}_leaves"] = _train_leaves(_as_got(other), want, leaves0)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=None,
                        help="read the control and the faults on the first this many seeds only")
    args = parser.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        control = args.control_seeds is None or i < args.control_seeds
        print(json.dumps({"workload": args.workload,
                          **readings(args.workload, seed, control=control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
