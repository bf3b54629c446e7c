"""Subject layer: per-participant dataset logic + per-tensor schemas.

Rebuilds the reference's ``subjects.py``:

* :class:`ECoGSubject` (reference subjects.py:27-271) — owns one
  DataGenerator, derives block→partition membership, the encoder conv
  stride (``decimation_factor``), and the per-tensor
  :class:`SequenceDataManifest` set consumed by the model/trainer.  It is
  the "params" object the seq2seq core reads: ``subnet_id``,
  ``block_ids``, ``decimation_factor``, ``input_mask``,
  ``data_manifests`` (reference subjects.py:56-62).
* :class:`SequenceDataManifest` (reference subjects.py:274-404) — the
  TFRecord schema + parse/transform spec per tensor: float sequences are
  stored flattened and reshaped with ``num_features_raw``; string
  sequences map to class indices with OOV fallback and optional
  ``<EOS>`` append; ``distribution`` picks the model's loss head;
  ``penalty_scale`` weights it.
* counters (reference subjects.py:486-600) — token histograms and
  WER-clustered sentence statistics.

The port's own copy of ``ecog2txt_tpu/subjects.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from . import DATA_PARTITIONS, EOS_token, pad_token
from .assess import word_error_rate
from .config import Manifest, load_block_breakdowns, resolve_data_generator
from .records import read_examples
from .tokenizers import oov_index


# --------------------------------------------------------------------------
# per-tensor schema
# --------------------------------------------------------------------------

_DISTRIBUTION_DEFAULTS = {
    # reference subjects.py:369-384
    "ecog_sequence": "Rayleigh",
    "audio_sequence": "Gaussian",
}


@dataclass
class SequenceDataManifest:
    """Schema + parse/transform spec for one tensor of the data mapping."""

    sequence_type: str  # e.g. 'ecog_sequence', 'text_sequence'
    num_features_raw: int = 1  # stored feature count (1 for strings)
    feature_list: Sequence[str] | None = None  # class list (categorical)
    input_mask: np.ndarray | None = None  # bool keep-mask over channels
    APPEND_EOS: bool = False
    penalty_scale: float = 1.0
    distribution: str | None = None

    def __post_init__(self):
        if self.distribution is None:
            self.distribution = _DISTRIBUTION_DEFAULTS.get(
                self.sequence_type, "categorical"
            )

    # -- accounting ---------------------------------------------------------

    @property
    def is_categorical(self) -> bool:
        # CTC targets parse identically (token strings → class ids);
        # they differ only in loss/packing (alignment-free)
        return self.distribution in ("categorical", "CTC")

    @property
    def num_features(self) -> int:
        """Post-transform feature count: class-list size for categorical,
        mask-surviving channels for float (reference subjects.py:304-336)."""
        if self.is_categorical:
            if self.feature_list is None:
                raise ValueError(
                    f"{self.sequence_type}: categorical manifest missing "
                    "feature_list"
                )
            return len(self.feature_list)
        if self.input_mask is not None:
            return int(np.sum(self.input_mask))
        return self.num_features_raw

    @property
    def padding_value(self):
        """0.0 for real-valued tensors, the ``<pad>`` index for
        categorical (reference subjects.py:386-404)."""
        if self.is_categorical:
            try:
                return self.feature_list.index(pad_token)
            except (ValueError, AttributeError):
                return 0
        return 0.0

    # -- parse/transform ----------------------------------------------------

    def parse(self, raw: np.ndarray | list) -> np.ndarray:
        """Stored value → model-ready (T, F) float or (L,) int32 array
        (reference subjects.py:338-367 transforms + the flattened-float
        reshape, trainers.py:864-866)."""
        if self.is_categorical:
            tokens = [
                t.decode("utf-8") if isinstance(t, bytes) else str(t)
                for t in raw
            ]
            index = {t: i for i, t in enumerate(self.feature_list)}
            oov = oov_index(self.feature_list)
            ids = [index.get(t, oov) for t in tokens]
            if self.APPEND_EOS:
                ids.append(index[EOS_token])
            return np.asarray(ids, dtype=np.int32)
        arr = np.asarray(raw, dtype=np.float32).reshape(
            -1, self.num_features_raw
        )
        if self.input_mask is not None:
            arr = arr[:, np.asarray(self.input_mask, dtype=bool)]
        return arr


# --------------------------------------------------------------------------
# subject
# --------------------------------------------------------------------------


class ECoGSubject:
    """One participant: generator + block partitioning + data manifests."""

    def __init__(
        self,
        manifest: Manifest,
        subject_id: int,
        pretrain_all_blocks: bool = False,
        target_specs: dict | None = None,
        DG_kwargs: dict | None = None,
        **overrides: object,
    ):
        # extra ES_kwargs override manifest keys for this subject (the
        # reference's auto_attribute kwarg>manifest semantics applied to
        # ECoGSubject ctor args, reference README.md:42, trainers.py:80).
        # A key absent from the YAML may still be legitimate — many keys
        # exist only as resolve-time defaults (Manifest.resolve supports
        # keys the file omits) — so only warn, with a typo hint, when a
        # CLOSE manifest/ctor key exists (e.g. 'pretrain_all_block');
        # otherwise the override simply ADDS the key (ADVICE r2).
        if overrides:
            for key in overrides:
                if key not in manifest:
                    import difflib

                    known = list(manifest) + [
                        "pretrain_all_blocks", "target_specs", "DG_kwargs"
                    ]
                    hint = difflib.get_close_matches(
                        key, known, n=1, cutoff=0.8
                    )
                    if hint:
                        import warnings

                        warnings.warn(
                            f"ES override {key!r} is not a manifest key "
                            f"— did you mean {hint[0]!r}? (it is added "
                            "as a new key either way)",
                            stacklevel=2,
                        )
            manifest = manifest.updated(overrides)
        self.manifest = manifest
        self.subject_id = int(subject_id)
        self.pretrain_all_blocks = pretrain_all_blocks
        self.target_specs = target_specs or {}
        self.input_mask: np.ndarray | None = None

        # block_breakdowns.json lives in the manifest's json_dir; when
        # that path does not exist on this machine (reference manifests
        # hardcode lab paths) fall back to text_dir — first an explicit
        # 'text_dir' override, then the packaged auxiliary/ directory
        # (which ships a demo block_breakdowns.json)
        json_dir = manifest.resolve("json_dir")
        if not (json_dir and os.path.isdir(json_dir)):
            from . import text_dir as _default_text_dir

            for candidate in (
                manifest.resolve("manifest_dir"),
                manifest.resolve("text_dir"),
                _default_text_dir,
            ):
                if candidate and os.path.isfile(
                    os.path.join(candidate, "block_breakdowns.json")
                ):
                    json_dir = candidate
                    break
        self.block_breakdowns = (
            load_block_breakdowns(json_dir).get(self.subject_id, {})
            if json_dir and os.path.isdir(json_dir)
            else {}
        )

        generator_cls = resolve_data_generator(manifest["DataGenerator"])
        self.data_generator = generator_cls(
            manifest, self.subject_id, **(DG_kwargs or {})
        )

        # data_mapping: model tensor key → sequence type (reference
        # mocha-1_word_sequence.yaml:41-44)
        self.data_mapping: dict[str, str] = dict(manifest["data_mapping"])
        self._manifest_overrides: dict[str, dict] = {
            key: {} for key in self.data_mapping
        }

    # -- identity -----------------------------------------------------------

    @property
    def subnet_id(self) -> str:
        """Scope id of this subject's proprietary input network."""
        return str(self.subject_id)

    # -- blocks -------------------------------------------------------------

    def block_ids(self, partition: str) -> set[int]:
        """Blocks belonging to a partition.  Membership requires
        ``default_dataset == partition`` AND ``type ∈
        block_types[partition]`` (necessary-conditions semantics,
        reference subjects.py:110-138, README.md:49).

        ``pretrain_all_blocks`` folds validation+testing blocks into
        training (transfer donors train on everything, reference
        trainers.py:76).  Non-empty ``target_specs`` → all blocks in all
        partitions (reference subjects.py:129-132).
        """
        if partition not in DATA_PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}")
        if self.target_specs:
            return set(self.block_breakdowns)
        block_types = self.manifest.resolve("block_types", default={})

        def members(part: str) -> set[int]:
            allowed = block_types.get(part, set())
            return {
                block
                for block, desc in self.block_breakdowns.items()
                if desc.get("default_dataset") == part
                and desc.get("type") in allowed
            }

        if partition == "training" and self.pretrain_all_blocks:
            return members("training") | members("validation") | members("testing")
        if self.pretrain_all_blocks and partition in ("validation", "testing"):
            return members(partition)
        return members(partition)

    @property
    def all_blocks(self) -> set[int]:
        return set().union(*(self.block_ids(p) for p in DATA_PARTITIONS))

    # -- model geometry -----------------------------------------------------

    @property
    def decimation_factor(self) -> int:
        """Encoder conv stride: explicit manifest value, else
        ``round(sampling_rate / sampling_rate_decimated)`` (reference
        subjects.py:144-157; e.g. 200/16.5 ≈ 12)."""
        explicit = self.manifest.resolve("decimation_factor")
        if explicit is not None:
            return int(explicit)
        rate = float(self.manifest.resolve("sampling_rate", default=200.0))
        decimated = float(
            self.manifest.resolve("sampling_rate_decimated", default=rate)
        )
        return max(int(round(rate / decimated)), 1)

    # -- data manifests -----------------------------------------------------

    def set_feature_list(self, tensor_key: str, class_list: Sequence[str]):
        self._manifest_overrides[tensor_key]["feature_list"] = list(class_list)

    def set_penalty_scale(self, tensor_key: str, scale: float):
        self._manifest_overrides[tensor_key]["penalty_scale"] = float(scale)

    def set_append_eos(self, tensor_key: str, value: bool):
        self._manifest_overrides[tensor_key]["APPEND_EOS"] = bool(value)

    @property
    def data_manifests(self) -> dict[str, SequenceDataManifest]:
        """Live-wired manifests: ``num_features_raw`` comes from the
        generator each access (channel/MFCC counts can change with
        geometry overrides — reference subjects.py:159-181)."""
        out = {}
        for tensor_key, sequence_type in self.data_mapping.items():
            overrides = self._manifest_overrides[tensor_key]
            if sequence_type == "ecog_sequence":
                raw = self.data_generator.num_ECoG_channels
            elif sequence_type == "audio_sequence":
                raw = self.data_generator.num_MFCC_features
            else:
                raw = 1
            mask = (
                self.input_mask
                if sequence_type == "ecog_sequence"
                else None
            )
            penalty = self.manifest.resolve(
                f"{sequence_type}_penalty_scale",
                overrides.get("penalty_scale"),
                1.0,
            )
            out[tensor_key] = SequenceDataManifest(
                sequence_type=sequence_type,
                num_features_raw=raw,
                feature_list=overrides.get("feature_list"),
                input_mask=mask,
                APPEND_EOS=overrides.get("APPEND_EOS", False),
                penalty_scale=float(penalty),
                # e.g. `phoneme_sequence_distribution: CTC` switches the
                # aux head to the alignment-free loss
                distribution=self.manifest.resolve(
                    f"{sequence_type}_distribution",
                    overrides.get("distribution"),
                ),
            )
        return out

    # -- records ------------------------------------------------------------

    def write_tf_records_maybe(
        self, sequence_type: str | None = None
    ) -> list[str]:
        """Ensure records exist for all partitions; return the induced
        class list (reference subjects.py:183-196)."""
        sequence_type = sequence_type or self.data_mapping.get(
            "decoder_targets", "text_sequence"
        )
        return self.data_generator.write_to_Protobuf_maybe(
            sequence_type, sorted(self.all_blocks)
        )

    def iterate_examples(self, partition: str):
        """Parsed (per-manifest) example dicts for a partition."""
        manifests = self.data_manifests
        for block in sorted(self.block_ids(partition)):
            path = self.data_generator.tf_record_path(block)
            for raw in read_examples(path):
                example = {}
                for tensor_key, manifest in manifests.items():
                    value = raw.get(manifest.sequence_type)
                    if value is None:
                        continue
                    example[tensor_key] = manifest.parse(value)
                example["block"] = block
                yield example

    # -- statistics ---------------------------------------------------------

    def count_targets(
        self, partitions: Iterable[str] = DATA_PARTITIONS, threshold: float = 0.4
    ) -> dict[str, "SequenceCounter"]:
        """Per-partition WER-clustered sentence statistics (reference
        subjects.py:198-242)."""
        counters = {}
        for partition in partitions:
            counter = SequenceCounter(threshold=threshold)
            for example in self.iterate_examples(partition):
                targets = example.get("decoder_targets")
                inputs = example.get("encoder_inputs")
                if targets is None:
                    continue
                manifest = self.data_manifests["decoder_targets"]
                tokens = [
                    manifest.feature_list[i] if manifest.feature_list else str(i)
                    for i in targets
                ]
                counter.observe(
                    " ".join(tokens),
                    ecog_length=0 if inputs is None else len(inputs),
                )
            counters[partition] = counter
        synchronize_sequence_counters(counters)
        return counters

    def get_unique_target_lengths(
        self, partition: str = "training"
    ) -> dict[str, dict]:
        counters = self.count_targets([partition])
        return counters[partition].length_stats()


# --------------------------------------------------------------------------
# counters
# --------------------------------------------------------------------------


class TargetCounter:
    """Token histogram over a fixed vocab (reference subjects.py:486-510)."""

    def __init__(self, vocab: Sequence[str]):
        self.vocab = list(vocab)
        self._index = {t: i for i, t in enumerate(self.vocab)}
        self.counts = np.zeros(len(self.vocab), dtype=np.int64)
        self.num_oov = 0

    def observe(self, tokens: Iterable[str]) -> None:
        for token in tokens:
            i = self._index.get(token)
            if i is None:
                self.num_oov += 1
            else:
                self.counts[i] += 1

    def histogram(self) -> dict[str, int]:
        return {t: int(c) for t, c in zip(self.vocab, self.counts) if c}


class SequenceCounter:
    """Cluster observed sentences by WER < threshold against a running
    unique-sentence list — tolerating transcription variants — and track
    per-sentence ECoG length stats (reference subjects.py:513-573)."""

    def __init__(self, threshold: float = 0.4):
        self.threshold = threshold
        self.unique_sentences: list[str] = []
        self.counts: list[int] = []
        self._lengths: list[list[int]] = []

    def observe(self, sentence: str, ecog_length: int = 0) -> int:
        """Match against known sentences; add a new cluster if none is
        within the WER threshold.  Returns the cluster index."""
        tokens = sentence.split()
        for i, known in enumerate(self.unique_sentences):
            if word_error_rate(known.split(), tokens) < self.threshold:
                self.counts[i] += 1
                self._lengths[i].append(ecog_length)
                return i
        self.unique_sentences.append(sentence)
        self.counts.append(1)
        self._lengths.append([ecog_length])
        return len(self.unique_sentences) - 1

    def pad_to(self, sentences: Sequence[str]) -> None:
        """Extend to a common sentence list (zero counts for unseen)."""
        for sentence in sentences:
            if sentence not in self.unique_sentences:
                self.unique_sentences.append(sentence)
                self.counts.append(0)
                self._lengths.append([])

    @property
    def lengths_means(self) -> list[float]:
        """Per-cluster mean ECoG length (reference subjects.py:566-568;
        empty clusters — padded by synchronize — give 0.0)."""
        return [
            float(np.mean(lengths)) if lengths else 0.0
            for lengths in self._lengths
        ]

    @property
    def lengths_std_errs(self) -> list[float]:
        """Per-cluster standard error sqrt(var/n) (reference
        subjects.py:570-573)."""
        return [
            float(np.sqrt(np.var(lengths) / len(lengths))) if lengths else 0.0
            for lengths in self._lengths
        ]

    def length_stats(self) -> dict[str, dict]:
        return {
            sentence: {
                "count": count,
                "mean_length": float(np.mean(lengths)) if lengths else 0.0,
                "std_length": float(np.std(lengths)) if lengths else 0.0,
            }
            for sentence, count, lengths in zip(
                self.unique_sentences, self.counts, self._lengths
            )
        }


def synchronize_sequence_counters(
    counters: dict[str, SequenceCounter]
) -> None:
    """Pad all partitions' counters to one common sentence list
    (reference subjects.py:576-600)."""
    all_sentences: dict[str, None] = {}
    for counter in counters.values():
        for sentence in counter.unique_sentences:
            all_sentences.setdefault(sentence)
    for counter in counters.values():
        counter.pad_to(list(all_sentences))


def apply_to_all_tf_examples(
    paths: Iterable[str],
    examplers: Sequence[Callable[[dict], Any]],
    parse_fn: Callable[[dict], dict] | None = None,
) -> None:
    """Map a parse over record files, feeding each example to callbacks
    (reference subjects.py:603-627, minus the TF1/TF2 dual path)."""
    for path in paths:
        for example in read_examples(path):
            if parse_fn is not None:
                example = parse_fn(example)
            for exampler in examplers:
                exampler(example)
