"""The general traffic generator: the corpus and the schedules of a mix.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``):

* ``kind``: which loop drives the program (``train``: the segment runner
  as ``MultiSubjectTrainer.fit`` drives it; ``assess``: the assessment
  decode as ``MultiSubjectTrainer.assess`` runs it);
* ``trials``, ``samples``, ``decoder_tokens``: the resident corpus, one
  subject's trials of ``samples`` raw samples and ``decoder_tokens``
  decoder targets;
* ``batch`` and ``epochs_per_segment`` (``train``): the minibatch and the
  epochs between two read-backs of the metrics;
* ``checked_steps`` (``train``): the first steps the reference follows;
* ``sampled_calls`` (``assess``): the calls whose tokens the reference
  judges, the last call among them.

Everything is drawn from the run's seed; two seeds give the same sizes,
the same number of steps in a segment and the same work, in another order.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (stable across
    processes, unlike ``hash``)."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def make_corpus(model: dict, traffic: dict, seed: int, device) -> dict:
    """One subject's resident trials, stacked ``(1, N, ...)`` on
    ``device`` as the trainer's ``device_data`` holds them: the ECoG
    inputs in the compute dtype, full lengths, decoder targets drawn from
    the vocabulary past ``<pad>``, ``<EOS>`` and ``<OOV>``, and per-sample
    targets of each auxiliary head."""
    N, T, L = int(traffic["trials"]), int(traffic["samples"]), int(traffic["decoder_tokens"])
    C = int(model["in_channels"])
    g = torch.Generator(device=device).manual_seed(derive(seed, "corpus"))
    data = {
        "encoder_inputs": torch.randn((1, N, T, C), generator=g, device=device,
                                      dtype=_DTYPES[model["compute_dtype"]]),
        "encoder_lengths": torch.full((1, N), T, dtype=torch.int32, device=device),
        "decoder_targets": torch.randint(3, int(model["vocab_size"]), (1, N, L), generator=g,
                                         device=device, dtype=torch.int32),
        "decoder_lengths": torch.full((1, N), L, dtype=torch.int32, device=device),
    }
    for head in model["aux_heads"]:
        data[head["name"]] = torch.randint(0, int(head["out_dim"]), (1, N, T), generator=g,
                                           device=device, dtype=torch.int32)
    return data


def segment_schedule(traffic: dict, seed: int, segment: int) -> tuple[np.ndarray, np.ndarray]:
    """``(subject_per_step (K,), indices_per_step (K, B))`` of one segment,
    as ``pipeline.make_schedule`` lays it out: each epoch a permutation of
    the trials, the last batch filled from the start of the permutation,
    the epoch's batches in a shuffled order.  The rows of a step all
    differ when the batch is at most the trials."""
    N, B = int(traffic["trials"]), int(traffic["batch"])
    rng = np.random.default_rng(derive(seed, "schedule", segment))
    steps = []
    for _ in range(int(traffic["epochs_per_segment"])):
        perm = rng.permutation(N)
        padded = np.concatenate([perm, np.resize(perm, (-N) % B)])
        batches = [padded[i : i + B] for i in range(0, len(padded), B)]
        steps += [batches[j] for j in rng.permutation(len(batches))]
    return np.zeros(len(steps), dtype=np.int64), np.stack(steps)


def dropout_generator(seed: int, segment: int, part: int, device) -> torch.Generator:
    """The dropout generator of one call of the segment runner: a fresh
    one for each call, as ``fit`` seeds one a segment."""
    return torch.Generator(device=device).manual_seed(derive(seed, "dropout", segment, part))


def gather_batch(corpus: dict, subject: int, idx) -> dict:
    """The rows of a step, as the segment runner gathers them."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=corpus["encoder_inputs"].device)
    batch = {k: v[subject][idx] for k, v in corpus.items()}
    batch["subject_idx"] = subject
    return batch
