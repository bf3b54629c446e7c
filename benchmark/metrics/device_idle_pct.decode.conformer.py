"""``device_idle_pct.decode`` of a conformer cell, beside the end-to-end metric it moves
there, ``decode_sentences_per_s.conformer``."""

from benchmark.harness.registry import reader

read = reader("device_idle_pct.decode")
