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


class LazyShardedDataset:
    """Shard-at-a-time loader over TFRecords: host memory stays
    O(shard), never O(corpus).

    Construction makes ONE streaming pass over the partition's records
    to learn the global padding dims and retain only the SMALL per-
    trial tensors (decoder targets, CTC label sequences, reference
    strings) plus each trial's (file, record#) address.  Iterating
    yields :class:`PackedDataset` shards of ``shard_trials`` rows whose
    heavy tensors (ECoG, frame-aligned aux) are re-read on demand
    through :class:`records.RecordFile` — random access over the mmap'd
    framing index, so a shard touches only its own bytes.

    Every shard has identical shapes (global dims); shard k holds rows [k·shard, (k+1)·shard) of
    EVERY subject, exactly like ``shard_dataset`` slicing a fully
    packed partition (asserted equal in tests)."""

    def __init__(
        self,
        subjects: Sequence[ECoGSubject],
        partition: str,
        shard_trials: int,
        pad_channels_to: int | None = None,
        pad_time_multiple: int | None = None,
        max_samples: int | None = None,
        trial_subset: dict[int, Sequence[int]] | None = None,
    ):
        from .records import read_examples

        self.subjects = list(subjects)
        self.partition = partition
        self.shard_trials = int(shard_trials)
        self._meta: list[dict] = []  # per subject
        per_subject_probe = []
        for subject in self.subjects:
            manifests = subject.data_manifests
            cap = max_samples or subject.data_generator.max_samples
            aux_keys: dict[str, str] = {}
            small: list[dict] = []  # per trial: address + small tensors
            probe_trials = []
            for block in sorted(subject.block_ids(partition)):
                path = subject.data_generator.tf_record_path(block)
                for r, raw in enumerate(read_examples(path)):
                    example = {
                        key: manifest.parse(raw[manifest.sequence_type])
                        for key, manifest in manifests.items()
                        if raw.get(manifest.sequence_type) is not None
                    }
                    trial = _trial_from_example(
                        example, manifests, cap, aux_keys
                    )
                    # measure, then DROP the heavy tensors
                    probe_trials.append(
                        {
                            "encoder_inputs": trial["encoder_inputs"][:0],
                            "decoder_targets": trial["decoder_targets"],
                            **{
                                k: trial[k]
                                for k, d in aux_keys.items()
                                if k in trial and d == "CTC"
                            },
                        }
                    )
                    t_shape = trial["encoder_inputs"].shape
                    gauss = {
                        k: trial[k].shape[1]
                        for k, d in aux_keys.items()
                        if k in trial and d not in ("CTC", "categorical")
                        and trial[k].ndim == 2
                    }
                    small.append(
                        {
                            "path": path,
                            "record": r,
                            "T": int(t_shape[0]),
                            "C": int(t_shape[1]),
                            "gauss": gauss,
                            "decoder_targets": trial["decoder_targets"],
                            "ctc": {
                                k: trial[k]
                                for k, d in aux_keys.items()
                                if k in trial and d == "CTC"
                            },
                        }
                    )
            self._meta.append(
                {
                    "manifests": manifests,
                    "cap": cap,
                    "aux_keys": aux_keys,
                    "trials": small,
                }
            )
            per_subject_probe.append(
                {
                    "trials": probe_trials,
                    "manifests": manifests,
                    "aux_keys": aux_keys,
                }
            )
        dims = _measure_dims(
            per_subject_probe, pad_channels_to, pad_time_multiple
        )
        # dims from the probe lack T/C (heavy tensors were dropped) and
        # Gaussian feature dims — restore them from the recorded shapes
        T_raw = max(
            (t["T"] for m in self._meta for t in m["trials"]), default=0
        )
        decim = pad_time_multiple or 1
        dims.T_max = _round_up(max(T_raw, decim), decim)
        dims.C_max = max(
            max(
                (t["C"] for m in self._meta for t in m["trials"]),
                default=0,
            ),
            pad_channels_to or 0,
        )
        for key in list(dims.aux_gauss_dim):
            dims.aux_gauss_dim[key] = max(
                (
                    t["gauss"].get(key, 1)
                    for m in self._meta
                    for t in m["trials"]
                ),
                default=1,
            )
        dims.N_max = self.shard_trials
        # restricted trial subsets (perf-vs-training-size sweeps on a
        # host-memory-bounded corpus): keep only the chosen trials of a
        # subject, compacted to the front — the lazy mirror of
        # restrict_trials.  Applied AFTER the dims probe, so padding
        # dims match the resident path (restrict_trials slices rows of
        # the already-packed full partition and keeps its padding).
        for s, indices in (trial_subset or {}).items():
            trials = self._meta[s]["trials"]
            self._meta[s]["trials"] = [
                trials[i] for i in sorted(int(i) for i in indices)
            ]
        self.dims = dims
        self._record_files: dict[str, Any] = {}

    @property
    def num_trials(self) -> np.ndarray:
        return np.asarray([len(m["trials"]) for m in self._meta])

    def trial_lengths(self, subject_index: int) -> np.ndarray:
        """Raw (pre-pad) time lengths of one subject's trials — lets
        the perf-vs-training-size sweep compute seconds-of-speech
        without materializing the corpus."""
        return np.asarray(
            [t["T"] for t in self._meta[subject_index]["trials"]],
            np.int64,
        )

    @property
    def num_subjects(self) -> int:
        return len(self._meta)

    def __len__(self) -> int:
        n = int(self.num_trials.max()) if len(self._meta) else 0
        return max(-(-n // self.shard_trials), 1)

    def _record_file(self, path: str):
        from .records import RecordFile

        rf = self._record_files.get(path)
        if rf is None:
            rf = self._record_files[path] = RecordFile(path)
        return rf

    def _materialize(self, start: int, end: int) -> PackedDataset:
        per_subject = []
        for meta in self._meta:
            manifests = meta["manifests"]
            trials = []
            for info in meta["trials"][start:end]:
                raw = self._record_file(info["path"]).example(info["record"])
                example = {
                    key: manifest.parse(raw[manifest.sequence_type])
                    for key, manifest in manifests.items()
                    if raw.get(manifest.sequence_type) is not None
                }
                trials.append(
                    _trial_from_example(
                        example, manifests, meta["cap"], dict(meta["aux_keys"])
                    )
                )
            per_subject.append(
                {
                    "trials": trials,
                    "manifests": manifests,
                    "aux_keys": meta["aux_keys"],
                }
            )
        return _pack_trials(per_subject, self.dims)

    def __iter__(self):
        for k in range(len(self)):
            yield self._materialize(
                k * self.shard_trials, (k + 1) * self.shard_trials
            )

    def close(self) -> None:
        for rf in self._record_files.values():
            rf.close()
        self._record_files.clear()


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


def shard_dataset(
    dataset: PackedDataset, shard_trials: int
) -> list[PackedDataset]:
    """Slice a packed dataset along the trial axis into equal-size
    shards (the last one zero-padded with masked rows).  The host-
    sharded streaming path for corpora exceeding device memory: shards
    upload one at a time, every shard with the same shapes."""
    N = dataset.encoder_inputs.shape[1]
    shard_trials = int(shard_trials)
    shards = []
    for start in range(0, N, shard_trials):
        end = min(start + shard_trials, N)
        pad = shard_trials - (end - start)

        def cut(a: np.ndarray) -> np.ndarray:
            piece = a[:, start:end]
            if pad:
                widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
                piece = np.pad(piece, widths)
            return piece

        refs = [
            r[start:end] + [[]] * pad for r in dataset.references
        ]
        shards.append(
            PackedDataset(
                encoder_inputs=cut(dataset.encoder_inputs),
                encoder_lengths=cut(dataset.encoder_lengths),
                decoder_targets=cut(dataset.decoder_targets),
                decoder_lengths=cut(dataset.decoder_lengths),
                aux_targets={
                    k: cut(v) for k, v in dataset.aux_targets.items()
                },
                trial_mask=cut(dataset.trial_mask),
                references=refs,
            )
        )
    return shards


_PREFETCH_END = object()


def prefetch(produce, depth: int = 1):
    """Run ``produce()`` (pull-next-item + host prep + device upload) in
    a single background thread, up to ``depth`` items ahead of the
    consumer — the streaming trainer's input pipeline overlap: while
    the device trains shard k, the host reads/packs/uploads shard k+1
    instead of idling the device between shards.

    ``produce`` must return :data:`_PREFETCH_END` when exhausted; one
    worker thread keeps pulls strictly ordered, so rng-dependent
    schedules are drawn in exactly the sequential order (the
    lazy-trajectory test asserts the same trajectory either way).  The
    trainer's ``produce`` uploads on a CUDA stream of its own and waits
    for it in the worker, so the copy overlaps the training kernels.

    DEVICE-MEMORY NOTE: with the default ``depth=1``, at most TWO
    uploaded shards are resident at once (the one training + the one
    prefetched) — a ``max_device_trials`` budget must leave room for
    both.  ``depth=0`` restores the strictly-one-shard behavior (no
    overlap)."""
    import concurrent.futures
    from collections import deque

    if depth <= 0:  # no overlap: strictly one shard alive at a time
        while True:
            item = produce()
            if item is _PREFETCH_END:
                return
            yield item

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        pending = deque([ex.submit(produce)])
        try:
            while pending:
                item = pending.popleft().result()
                if item is _PREFETCH_END:
                    break
                # keep exactly `depth` producers in flight: while the
                # consumer holds this item, at most `depth` more shards
                # can complete — never an unbounded backlog
                while len(pending) < max(depth, 1):
                    pending.append(ex.submit(produce))
                yield item
        finally:
            for fut in pending:
                fut.cancel()


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
