"""The closed loops that drive the program, one per traffic ``kind``.

A driver's life in a run: ``setup`` (the program's state, the checked
first steps, the warm-up of the shapes the window uses), ``measure``
(the window, host clock, ending in a read-back), ``trace`` (a short
window under the profiler, ``--trace 1`` only), ``release`` (the
program's state freed), ``judge`` (the reference, after the window).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import seq2seq as ref
from . import port, traffic as tr
from .judge import decode_gap, train_numbers
from .trace import cuda_synchronize, summarize, traced


def _clone(tree):
    return ref.tree_map(lambda t: t.detach().clone(), tree)


class TrainDriver:
    """``run_segment`` driven as ``MultiSubjectTrainer.fit`` drives it:
    one call a segment of ``epochs_per_segment`` epochs, each with a
    fresh dropout generator, then its metrics read back to the host."""

    def __init__(self, config: dict, traffic: dict, corpus: dict, weights: dict, seed: int,
                 device):
        self.model, self.training = config["model"], config["training"]
        self.traffic, self.corpus, self.seed, self.device = traffic, corpus, seed, device
        self.weights0 = _clone(weights)  # the benchmark's copy, for the reference
        self.cfg = port.seq2seq_config(self.model)
        self.state = port.train_state(weights, float(self.training["learning_rate"]))
        self.runner = port.segment_runner(self.cfg, self.training)
        self.batch = int(traffic["batch"])
        self.segment = 0
        self.failed = 0

    def _call(self, subjects, idx, part: int, epochs: int) -> dict:
        gen = tr.dropout_generator(self.seed, self.segment, part, self.device)
        self.state, metrics = self.runner(self.state, self.corpus, subjects, idx, gen, epochs)
        values = {k: float(v) for k, v in metrics.items()}  # the read-back fit makes
        if not np.isfinite(values.get("loss_total", 0.0)):
            self.failed += len(idx)
        return values

    def setup(self) -> None:
        """Segment 0: its first step as one call, steps 2 to
        ``checked_steps`` as one call of the timed kind (the reference
        follows both), then the rest of it as another."""
        subjects, idx = tr.segment_schedule(self.traffic, self.seed, 0)
        k = int(self.traffic["checked_steps"])
        self.first_metrics = self._call(subjects[:1], idx[:1], 0, 0)
        self.grads1 = [g.clone() for g in port.first_gradient(self.state)]
        self.checked_metrics = self._call(subjects[1:k], idx[1:k], 1, 0)
        self.params_k = _clone(port.leaves(self.state.params))
        self.ema_k = _clone(port.leaves(self.state.ema))
        self.checked = (subjects[:k], idx[:k])
        self._call(subjects[k:], idx[k:], 2, int(self.traffic["epochs_per_segment"]))
        self.segment = 1

    def _segment(self) -> int:
        subjects, idx = tr.segment_schedule(self.traffic, self.seed, self.segment)
        self._call(subjects, idx, 0, int(self.traffic["epochs_per_segment"]))
        self.segment += 1
        return len(idx)

    def measure(self, seconds: float) -> dict:
        steps, t0 = 0, time.perf_counter()
        while True:
            steps += self._segment()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"seconds": elapsed, "units": steps, "sentences": steps * self.batch,
                "attempted": steps, "failed": self.failed}

    def trace(self, segments: int):
        steps = 0
        with traced() as holder:
            for _ in range(segments):
                steps += self._segment()
        return summarize(holder[0], steps)

    def release(self) -> None:
        del self.state, self.runner
        cuda_synchronize(self.device)
        torch.cuda.empty_cache() if torch.device(self.device).type == "cuda" else None

    def reference_steps(self):
        """The checked steps' rows, and their dropout masks drawn again from
        the checked calls' generators, step after step as the program draws
        them."""
        subjects, idx = self.checked
        T, L = int(self.traffic["samples"]), int(self.traffic["decoder_tokens"])
        gens = [tr.dropout_generator(self.seed, 0, part, self.device) for part in (0, 1)]
        return [(tr.gather_batch(self.corpus, int(subjects[k]), idx[k]),
                 ref.draw_masks(self.model, gens[min(k, 1)], len(idx[k]), T, L, self.device))
                for k in range(len(idx))]

    def reference(self, steps=None, precision: str = "float32") -> dict:
        """The reference over the checked steps (or ``steps``) from the
        benchmark's copy of the first weights."""
        return ref.train_steps(self.weights0, self.model, self.training,
                               steps or self.reference_steps(), precision,
                               self.traffic.get("reference_rows"))

    def judge(self) -> dict:
        steps = self.reference_steps()
        return train_numbers(self.outputs(), self.reference(steps), ref.leaves(self.weights0),
                             self.reference(steps[:1], "bfloat16"))

    def outputs(self) -> dict:
        """What the program produced over the checked steps: the first
        call's losses and the clipped gradient its optimizer got, the second
        call's mean loss, and the parameters and the EMA after it."""
        def parts(metrics):
            heads = {h["name"]: metrics[f"loss_{h['name']}"] for h in self.model["aux_heads"]}
            return {**heads, "decoder_targets": metrics["loss_decoder"]}

        return {"loss1": self.first_metrics["loss_total"], "parts1": parts(self.first_metrics),
                "grads1": self.grads1, "loss": self.checked_metrics["loss_total"],
                "params": self.params_k, "ema": self.ema_k}


class AssessDriver:
    """``greedy_decode`` of the whole resident partition under
    ``torch.inference_mode`` on the EMA weights, its tokens read back to
    the host, one call after another (``MultiSubjectTrainer.assess``)."""

    def __init__(self, config: dict, traffic: dict, corpus: dict, weights: dict, seed: int,
                 device):
        self.model, self.traffic, self.seed, self.device = config["model"], traffic, seed, device
        self.weights = weights
        self.cfg = port.seq2seq_config(self.model)
        self.inputs = corpus["encoder_inputs"][0]
        self.lengths = corpus["encoder_lengths"][0]
        self.tokens: list[np.ndarray] = []
        self.failed = 0

    def _call(self) -> np.ndarray:
        gen = torch.Generator(device=self.device).manual_seed(tr.derive(self.seed, "assess"))
        return port.decode(self.weights, self.cfg, self.inputs, self.lengths, gen).cpu().numpy()

    def setup(self) -> None:
        for _ in range(2):
            self._call()

    def measure(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.tokens.append(self._call())
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        calls = len(self.tokens)
        return {"seconds": elapsed, "units": calls, "sentences": calls * self.inputs.shape[0],
                "attempted": calls, "failed": self.failed}

    def trace(self, calls: int):
        with traced() as holder:
            for _ in range(calls):
                self._call()
        return summarize(holder[0], calls)

    def release(self) -> None:
        cuda_synchronize(self.device)

    def sampled_calls(self) -> list[int]:
        """The calls the reference judges: the last one and others drawn
        from the seed."""
        n = len(self.tokens)
        rng = np.random.default_rng(tr.derive(self.seed, "sampled_calls"))
        k = min(int(self.traffic["sampled_calls"]), n)
        return sorted({n - 1, *rng.choice(n, size=k - 1, replace=False).tolist()})

    def judge(self, precision: str = "float32") -> dict:
        """The widest gap by which a served token's logit lies below the
        reference's best, over the sampled calls.  ``precision`` other
        than float32 judges the tokens that precision would put first."""
        gap, cache = 0.0, {}
        for i in self.sampled_calls():
            served = self.tokens[i]
            key = served.tobytes()
            if key not in cache:
                cache[key] = decode_gap(self.weights, self.model, self.inputs, self.lengths,
                                        served, precision, self.traffic.get("reference_rows"))
            gap = max(gap, cache[key])
        return {"logit_gap": gap}


DRIVERS = {"train": TrainDriver, "assess": AssessDriver}
