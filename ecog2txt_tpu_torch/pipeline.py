"""Input pipeline: records → padded, stacked, device-resident tensors.

The reference streams TFRecords through a tf.data pipeline once per epoch
(CPU parse → pad-batch → GPU prefetch; probe: reference trainers.py:
775-782).  At this corpus scale (hundreds of trials — SURVEY §6) the
TPU-native answer is different: **parse once, pad once, put the whole
corpus in HBM**, then let the training loop gather minibatches on-device
with a traced index — so an entire assessment interval of epochs runs as
ONE `lax.scan` with zero host↔device traffic.

Layout: every per-subject array gets a leading subject axis padded to
common sizes — ``(S, N, T, C)`` inputs, ``(S, N, L)`` targets — so
multi-subject joint transfer training (reference
``parallel_transfer_learn``) is a single compiled program; the per-step
``(subject_idx, trial_indices)`` schedule is precomputed host-side.

Padding conventions:
* time padded to a multiple of the decimation factor (keeps the conv
  reshape exact), channels to the max across subjects (zero-fill),
* trial counts to the max across subjects, with a validity mask,
* decoder targets to max length with ``<pad>``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from .subjects import ECoGSubject


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class PackedDataset:
    """One partition, all subjects, fully padded + stacked (numpy; moved
    to device by the trainer)."""

    encoder_inputs: np.ndarray  # (S, N, T, C) float32
    encoder_lengths: np.ndarray  # (S, N) int32
    decoder_targets: np.ndarray  # (S, N, L) int32
    decoder_lengths: np.ndarray  # (S, N) int32
    aux_targets: dict[str, np.ndarray]  # name → (S, N, T[, F])
    trial_mask: np.ndarray  # (S, N) bool — real trial vs ragged padding
    references: list[list[list[str]]]  # [subject][trial] → token strings

    @property
    def num_subjects(self) -> int:
        return self.encoder_inputs.shape[0]

    @property
    def num_trials(self) -> np.ndarray:
        return self.trial_mask.sum(axis=1)

    def batch_dict(self) -> dict[str, np.ndarray]:
        out = {
            "encoder_inputs": self.encoder_inputs,
            "encoder_lengths": self.encoder_lengths,
            "decoder_targets": self.decoder_targets,
            "decoder_lengths": self.decoder_lengths,
        }
        out.update(self.aux_targets)
        return out


def _trial_from_example(
    example: dict, manifests: dict, cap: int, aux_keys: dict
) -> dict:
    """example (per-manifest parsed tensors) → packed-trial dict,
    clipping to ``cap`` samples and collapsing CTC alignments.  Updates
    ``aux_keys`` (name → distribution) as new aux tensors appear."""
    enc = example["encoder_inputs"]
    if len(enc) > cap:
        enc = enc[:cap]
    trial = {"encoder_inputs": enc}
    for key, manifest in manifests.items():
        if key in ("encoder_inputs", "decoder_targets"):
            continue
        value = example.get(key)
        if value is None:
            continue
        aux_keys[key] = manifest.distribution
        if manifest.distribution == "CTC":
            # alignment-free target: collapse frame-aligned labels to
            # the label sequence (models/ctc.py)
            from .models.ctc import collapse_alignment

            trial[key] = collapse_alignment(value)
        else:
            trial[key] = value[: len(enc)]
    trial["decoder_targets"] = example["decoder_targets"]
    return trial


@dataclass
class PackDims:
    """Global padding dimensions shared by every shard of a partition
    (so the jitted train segment compiles once)."""

    N_max: int
    T_max: int
    C_max: int
    L_max: int
    aux_keys: dict[str, str]  # name → distribution
    aux_ctc_len: dict[str, int]
    aux_gauss_dim: dict[str, int]


def _measure_dims(
    per_subject: list[dict],
    pad_channels_to: int | None,
    pad_time_multiple: int | None,
) -> PackDims:
    C_max = T_max = 0
    L_max = N_max = 1
    aux_keys: dict[str, str] = {}
    aux_ctc: dict[str, int] = {}
    aux_gauss: dict[str, int] = {}
    for ps in per_subject:
        for t in ps["trials"]:
            T_max = max(T_max, len(t["encoder_inputs"]))
            C_max = max(C_max, t["encoder_inputs"].shape[1])
            L_max = max(L_max, len(t["decoder_targets"]))
        N_max = max(N_max, len(ps["trials"]))
        aux_keys.update(ps.get("aux_keys", {}))
    for key, dist in aux_keys.items():
        if dist == "CTC":
            aux_ctc[key] = max(
                (
                    len(t[key])
                    for ps in per_subject
                    for t in ps["trials"]
                    if key in t
                ),
                default=1,
            )
        elif dist != "categorical":
            aux_gauss[key] = max(
                (
                    t[key].shape[1]
                    for ps in per_subject
                    for t in ps["trials"]
                    if key in t and t[key].ndim == 2
                ),
                default=1,
            )
    if pad_channels_to is not None:
        C_max = max(C_max, pad_channels_to)
    decim = pad_time_multiple or 1
    T_max = _round_up(max(T_max, decim), decim)
    return PackDims(N_max, T_max, C_max, L_max, aux_keys, aux_ctc, aux_gauss)


def _pack_trials(
    per_subject: list[dict], dims: PackDims
) -> PackedDataset:
    """Fill the padded (S, N, ...) arrays from per-subject trial lists.
    ``per_subject[s]`` = {'trials': [...], 'manifests': ..., optional
    'offset': first trial's row index (lazy shards)}."""
    S = len(per_subject)
    N_max = dims.N_max
    enc = np.zeros((S, N_max, dims.T_max, dims.C_max), np.float32)
    enc_len = np.zeros((S, N_max), np.int32)
    dec = np.zeros((S, N_max, dims.L_max), np.int32)
    dec_len = np.zeros((S, N_max), np.int32)
    mask = np.zeros((S, N_max), bool)
    aux: dict[str, np.ndarray] = {}
    refs: list[list[list[str]]] = []
    for key, dist in dims.aux_keys.items():
        if dist == "CTC":
            aux[key] = np.zeros((S, N_max, dims.aux_ctc_len[key]), np.int32)
            aux[f"{key}_lengths"] = np.zeros((S, N_max), np.int32)
        elif dist == "categorical":
            aux[key] = np.zeros((S, N_max, dims.T_max), np.int32)
        else:
            aux[key] = np.zeros(
                (S, N_max, dims.T_max, dims.aux_gauss_dim[key]), np.float32
            )

    for s, ps in enumerate(per_subject):
        manifests = ps["manifests"]
        dec_manifest = manifests["decoder_targets"]
        pad_id = int(dec_manifest.padding_value)
        dec[s] = pad_id
        subject_refs = []
        for n, trial in enumerate(ps["trials"]):
            e = trial["encoder_inputs"]
            enc[s, n, : len(e), : e.shape[1]] = e
            enc_len[s, n] = len(e)
            d = trial["decoder_targets"]
            dec[s, n, : len(d)] = d
            dec_len[s, n] = len(d)
            mask[s, n] = True
            for key in aux:
                if key not in trial:
                    continue
                v = trial[key]
                if dims.aux_keys.get(key) == "CTC":
                    aux[key][s, n, : len(v)] = v
                    aux[f"{key}_lengths"][s, n] = len(v)
                elif v.ndim == 1:
                    # frame-aligned categorical labels at the raw rate;
                    # the zero tail never enters the loss (seq2seq_loss
                    # reverses the valid prefix by encoder_lengths and
                    # masks by step)
                    L = min(len(v), dims.T_max)
                    aux[key][s, n, :L] = v[:L]
                else:
                    L = min(len(v), dims.T_max)
                    aux[key][s, n, :L, : v.shape[1]] = v[:L]
            if dec_manifest.feature_list is not None:
                tokens = [
                    dec_manifest.feature_list[i]
                    for i in trial["decoder_targets"]
                ]
            else:
                tokens = [str(i) for i in trial["decoder_targets"]]
            subject_refs.append(tokens)
        subject_refs += [[]] * (N_max - len(subject_refs))
        refs.append(subject_refs)

    return PackedDataset(
        encoder_inputs=enc,
        encoder_lengths=enc_len,
        decoder_targets=dec,
        decoder_lengths=dec_len,
        aux_targets=aux,
        trial_mask=mask,
        references=refs,
    )


def pack_partition(
    subjects: Sequence[ECoGSubject],
    partition: str,
    pad_channels_to: int | None = None,
    pad_time_multiple: int | None = None,
    max_samples: int | None = None,
) -> PackedDataset:
    """Parse + pad one partition for all subjects.

    ``pad_time_multiple`` defaults to the decimation factor; trials
    longer than ``max_samples`` (default: each generator's cap, reference
    data_generators.py:298-313) are clipped with the same semantics.
    """
    per_subject: list[dict[str, Any]] = []
    for subject in subjects:
        manifests = subject.data_manifests
        cap = max_samples or subject.data_generator.max_samples
        aux_keys: dict[str, str] = {}
        trials = [
            _trial_from_example(example, manifests, cap, aux_keys)
            for example in subject.iterate_examples(partition)
        ]
        per_subject.append(
            {"trials": trials, "manifests": manifests, "aux_keys": aux_keys}
        )
    dims = _measure_dims(per_subject, pad_channels_to, pad_time_multiple)
    packed = _pack_trials(per_subject, dims)
    # full pack keeps exact (non-padded) reference lists
    packed.references = [
        refs[: int(n)]
        for refs, n in zip(packed.references, packed.num_trials)
    ]
    return packed


def restrict_trials(
    dataset: PackedDataset, subject_index: int, indices: Sequence[int]
) -> PackedDataset:
    """New dataset keeping only ``indices`` of one subject's trials
    (compacted to the front; other subjects untouched).  Used by the
    perf-vs-training-size sweeps (experiments.py)."""
    idx = np.asarray(sorted(indices), np.int64)
    s = subject_index

    def take(a: np.ndarray) -> np.ndarray:
        out = a.copy()
        row = np.zeros_like(a[s])
        row[: len(idx)] = a[s][idx]
        out[s] = row
        return out

    refs = [list(r) for r in dataset.references]
    refs[s] = [refs[s][i] for i in idx]
    return PackedDataset(
        encoder_inputs=take(dataset.encoder_inputs),
        encoder_lengths=take(dataset.encoder_lengths),
        decoder_targets=take(dataset.decoder_targets),
        decoder_lengths=take(dataset.decoder_lengths),
        aux_targets={k: take(v) for k, v in dataset.aux_targets.items()},
        trial_mask=take(dataset.trial_mask),
        references=refs,
    )


def make_schedule(
    dataset: PackedDataset,
    batch_size: int,
    num_epochs: int,
    rng: np.random.Generator,
    subject_subset: Sequence[int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side minibatch schedule for a scanned training segment.

    Returns (subject_per_step (K,), indices_per_step (K, B)): for each
    step, one subject and B trial indices into that subject's row.
    Every epoch visits each subject's real trials once (shuffled);
    ragged last batches wrap around (sampling with slight replacement —
    train-only; assessment is exact)."""
    steps_subject: list[int] = []
    steps_idx: list[np.ndarray] = []
    subjects = (
        list(range(dataset.num_subjects))
        if subject_subset is None
        else list(subject_subset)
    )
    counts = dataset.num_trials
    for _ in range(num_epochs):
        epoch_steps: list[tuple[int, np.ndarray]] = []
        for s in subjects:
            n = int(counts[s])
            if n == 0:
                continue
            perm = rng.permutation(n)
            pad = (-len(perm)) % batch_size
            if pad:
                # wrap around (tiling handles batch_size > n too)
                filler = np.resize(perm, pad)
                padded = np.concatenate([perm, filler])
            else:
                padded = perm
            for i in range(0, len(padded), batch_size):
                epoch_steps.append((s, padded[i : i + batch_size]))
        order = rng.permutation(len(epoch_steps))
        for j in order:
            s, idx = epoch_steps[j]
            steps_subject.append(s)
            steps_idx.append(idx)
    if not steps_idx:
        raise ValueError(
            "empty training schedule: no subject has trials in this "
            "partition/subset"
        )
    return (
        np.asarray(steps_subject, np.int32),
        np.stack(steps_idx).astype(np.int32),
    )
