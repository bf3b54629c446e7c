"""``decode_sentences_per_s`` of a conformer cell, under a bound of its own:
the conformer's host-paced decode spreads far more than the biLSTM's
device-bound one."""

from benchmark.harness.registry import reader

read = reader("decode_sentences_per_s")
