"""What a metric's reader (``metrics/<name>.py``: ``read(ctx)``) is given."""

from __future__ import annotations

from dataclasses import dataclass

from .trace import Trace


@dataclass
class Context:
    kind: str  # the traffic's kind: 'train' or 'assess'
    model: dict  # the configuration's model section
    traffic: dict  # the traffic mix's parameters
    setup_s: float  # host clock, process start to the end of the warm-up
    window: dict  # the measured window: seconds, units, sentences, attempted, failed
    trace: Trace | None  # the traced window (``--trace 1``), else None

    def sentences_per_s(self) -> float:
        return self.window["sentences"] / self.window["seconds"]

    def encoder_steps(self) -> int:
        from ..reference.seq2seq import encoder_steps

        return encoder_steps(self.model, int(self.traffic["samples"]))

    def batch(self) -> int:
        """Rows a step (train) or a call (assess) encodes."""
        return int(self.traffic["batch"] if self.kind == "train" else self.traffic["trials"])
