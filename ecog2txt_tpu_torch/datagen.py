"""Data generation: the featurization contract + a synthetic backend.

Rebuilds the reference's ``ECoGDataGenerator`` shell (reference
data_generators.py:45-531).  Users subclass and provide three methods
(reference README.md:59-66):

* ``_ecog_token_generator(block)`` — yield one dict per trial:
  ``{'ecog_sequence': (T, C) float, 'text_sequence': [str],
  'audio_sequence': (T_a, F) float, 'phoneme_sequence': [str]}``;
* ``_get_wav_data(index) -> (rate, signal)``;
* ``_query(block_set) -> int`` (trial count, for preallocation).

The shell supplies electrode geometry (via :mod:`geometry`), sequence-
length policy, MFCC features (via :mod:`audio`), tokenization (via
:mod:`tokenizers`), and the TFRecord write/read-back path (via
:mod:`records`).

The reference's real generators (``SpeechDataGenerator`` /
``BambooDataGenerator``) live in non-public lab repos, so
:class:`SyntheticDataGenerator` provides a deterministic fake backend:
each sentence deterministically drives per-word spatiotemporal ECoG
patterns, making WER→0 learnable — the seam for end-to-end tests.

The port's own copy of ``ecog2txt_tpu/datagen.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.  The file-backed
:class:`ArrayDataGenerator` featurizes raw-voltage trials through the
port's ``features`` chain on its ``device`` (CUDA unless told otherwise).
"""

from __future__ import annotations

import math
import os
import warnings
from abc import ABC, abstractmethod
from typing import Any, Iterable, Iterator

import numpy as np

from .audio import mfcc_chain, num_mfcc_features
from .config import Manifest, register_data_generator, set_fallback_generator
from .geometry import ElectrodeGrid
from .records import TFRecordWriter, encode_example, read_examples
from .tokenizers import (
    SubwordEncoder,
    read_vocab_file,
    sentence_tokenize,
    with_special_tokens,
)

# Per-token-type sequence caps in seconds (reference
# data_generators.py:35-42: 0.2 s phonemes … 6.25 s sequences/trials).
MAX_SECONDS = {
    "phoneme": 0.2,
    "word": 1.0,
    "trial": 6.25,
    "word_sequence": 6.25,
    "word_piece_sequence": 6.25,
    "phoneme_sequence": 6.25,
}

SEQUENCE_KEYS = (
    "ecog_sequence",
    "text_sequence",
    "audio_sequence",
    "phoneme_sequence",
)


class ECoGDataGenerator(ABC):
    """Featurization shell.  Ctor kwargs follow the explicit resolution
    rule kwarg > manifest > default (the reference's ``auto_attribute``
    back-fill, README.md:42)."""

    def __init__(self, manifest: Manifest, subject_id: int | str, **kwargs: Any):
        self.manifest = manifest
        self.subject_id = subject_id

        def res(key, default=None):
            return manifest.resolve(key, kwargs.get(key), default)

        self.grid_size = res("grid_size", (8, 8))
        self.grid_step = int(res("grid_step", 1))
        self.USE_FIELD_POTENTIALS = bool(res("USE_FIELD_POTENTIALS", False))
        self.REFERENCE_BIPOLAR = bool(res("REFERENCE_BIPOLAR", False))
        self.sampling_rate = float(res("sampling_rate", 200.0))
        self.token_type = res("token_type", "word_sequence")
        self.num_mel_features = int(res("num_mel_features", 26))
        self.num_cepstral_coeffs = int(res("num_cepstral_coeffs", 13))
        self.USE_LOG_MELS = bool(res("USE_LOG_MELS", False))
        self.USE_MFCC_DELTAS = bool(res("USE_MFCC_DELTAS", False))
        self.mfcc_winlen = float(res("mfcc_winlen", 0.02))
        self._tf_record_partial_path = res("tf_record_partial_path")
        # text_dir: where vocab files and the default bad_electrodes
        # file live (reference __init__.py:10, README.md:49); kwarg or
        # manifest may override the packaged auxiliary/ default (e.g.
        # the trainer forwards its text_dir argument here)
        from . import text_dir as _text_dir

        self.text_dir = res("text_dir", _text_dir)
        # default falls back to text_dir/bad_electrodes like the
        # reference (data_generators.py:205-215); the file is only
        # consulted if it exists
        self.bad_electrodes_path = res(
            "bad_electrodes_path",
            os.path.join(self.text_dir, "bad_electrodes"),
        )
        # explicit bad/good electrode overrides (reference allows direct
        # manifest/kwarg override, data_generators.py:173-197)
        self._bad_electrodes = kwargs.get("bad_electrodes")
        self._max_seconds = res("max_seconds")
        self._max_samples = res("max_samples")
        self.pad_value = float(res("pad_value", 0.0))
        self.vprint = print if kwargs.get("VERBOSE", True) else (lambda *a, **k: None)

    # ---- geometry ---------------------------------------------------------

    @property
    def bad_electrodes(self) -> set[int]:
        if self._bad_electrodes is not None:
            return set(self._bad_electrodes)
        if self.bad_electrodes_path and os.path.exists(self.bad_electrodes_path):
            from .geometry import load_bad_electrodes

            return load_bad_electrodes(self.bad_electrodes_path)
        return set()

    @property
    def grid(self) -> ElectrodeGrid:
        return ElectrodeGrid(
            grid_size=self.grid_size,
            grid_step=self.grid_step,
            bad_electrodes=self.bad_electrodes,
            USE_FIELD_POTENTIALS=self.USE_FIELD_POTENTIALS,
            REFERENCE_BIPOLAR=self.REFERENCE_BIPOLAR,
        )

    @property
    def elec_layout(self) -> np.ndarray:
        return self.grid.layout

    @property
    def good_electrodes(self) -> set[int]:
        return self.grid.good_electrodes

    @property
    def good_channels(self) -> list[int]:
        return self.grid.good_channels

    @property
    def bipolar_to_elec_map(self) -> list[tuple[int, int]]:
        return self.grid.bipolar_to_elec_map

    @property
    def num_ECoG_channels(self) -> int:
        return self.grid.num_channels

    # ---- sequence-length policy ------------------------------------------

    @property
    def max_seconds(self) -> float:
        """Explicit override > token-type table (reference
        data_generators.py:139-161)."""
        if self._max_seconds is not None:
            return float(self._max_seconds)
        return MAX_SECONDS[self.token_type]

    @property
    def max_samples(self) -> int:
        if self._max_samples is not None:
            return int(self._max_samples)
        return int(math.floor(self.sampling_rate * self.max_seconds))

    # ---- MFCC accounting --------------------------------------------------

    @property
    def num_MFCC_features(self) -> int:
        return num_mfcc_features(
            self.num_mel_features,
            self.num_cepstral_coeffs,
            self.USE_LOG_MELS,
            self.USE_MFCC_DELTAS,
        )

    def _get_MFCC_features(self, rate: float, signal: np.ndarray) -> np.ndarray:
        """Audio → MFCC frames at one frame per ECoG sample (reference
        data_generators.py:328-380)."""
        if signal is None or len(signal) == 0:
            return np.zeros((0, self.num_MFCC_features), dtype=np.float32)
        return mfcc_chain(
            signal,
            rate,
            winlen=self.mfcc_winlen,
            winstep=1.0 / self.sampling_rate,
            num_mel_features=self.num_mel_features,
            num_cepstral_coeffs=self.num_cepstral_coeffs,
            USE_LOG_MELS=self.USE_LOG_MELS,
            USE_MFCC_DELTAS=self.USE_MFCC_DELTAS,
        ).astype(np.float32)

    # ---- record paths -----------------------------------------------------

    @property
    def tf_record_partial_path(self) -> str:
        """Path template with ``{0}`` = block id; a ``lowdensity_bipolar``
        subdir is inserted when bipolar-referencing a strided grid
        (reference data_generators.py:122-133)."""
        path = self._tf_record_partial_path
        if path is None:
            raise ValueError("tf_record_partial_path not configured")
        if self.REFERENCE_BIPOLAR and self.grid_step > 1:
            head, tail = os.path.split(path)
            path = os.path.join(head, "lowdensity_bipolar", tail)
        return path

    def tf_record_path(self, block: int) -> str:
        return self.tf_record_partial_path.format(block)

    # ---- subclass contract (reference data_generators.py:487-530) --------

    @abstractmethod
    def _ecog_token_generator(self, block: int) -> Iterator[dict[str, Any]]:
        """Yield one trial dict per trial in the block."""

    @abstractmethod
    def _get_wav_data(self, index: Any) -> tuple[float, np.ndarray]:
        """(sample rate, audio signal) for one trial."""

    @abstractmethod
    def _query(self, block_set: Iterable[int]) -> int:
        """Number of trials across the blocks."""

    # ---- tokenization -----------------------------------------------------

    def _sentence_tokenize(self, sentence: str) -> list[str]:
        subword_encoder = None
        if self.token_type == "word_piece_sequence":
            subword_encoder = self._subword_encoder()
        return sentence_tokenize(sentence, self.token_type, subword_encoder)

    def _subword_encoder(self) -> SubwordEncoder:
        vocab_file = self.manifest.resolve("text_sequence_vocab_file")
        if vocab_file is None:
            raise ValueError("word_piece_sequence requires a vocab file")
        path = (
            vocab_file
            if os.path.isabs(vocab_file)
            else os.path.join(self.text_dir, vocab_file)
        )
        return SubwordEncoder.from_vocab_file(path)

    def get_class_list(self, sequence_type: str = "text_sequence") -> list[str]:
        """Vocab for a sequence type: vocab file in text_dir if configured
        (one token per line), else induced from the records (reference
        data_generators.py:427-444)."""
        vocab_file = self.manifest.resolve(f"{sequence_type}_vocab_file")
        if vocab_file is not None:
            path = (
                vocab_file
                if os.path.isabs(vocab_file)
                else os.path.join(self.text_dir, vocab_file)
            )
            if os.path.exists(path):
                return read_vocab_file(path)
            warnings.warn(f"vocab file {path} missing; inducing from records")
        return self.write_to_Protobuf_maybe(sequence_type, self._all_blocks())

    def _all_blocks(self) -> list[int]:
        raise NotImplementedError(
            "subclass must supply blocks for vocab induction"
        )

    # ---- in-memory tensor path (reference data_generators.py:247-315) ----

    def get(
        self,
        block_set: Iterable[int],
        sequence_types: tuple[str, ...] = ("ecog_sequence",),
    ) -> dict[str, np.ndarray | list]:
        """Convenience in-memory path: preallocate
        ``(num_examples, max_samples, C)``, zero-pad each trial, warn on
        clips.  Training never uses this (README.md:66)."""
        block_set = list(block_set)
        num_examples = self._query(block_set)
        out: dict[str, Any] = {}
        for st in sequence_types:
            if st == "ecog_sequence":
                out[st] = np.zeros(
                    (num_examples, self.max_samples, self.num_ECoG_channels),
                    dtype=np.float32,
                )
            elif st == "audio_sequence":
                out[st] = np.zeros(
                    (num_examples, self.max_samples, self.num_MFCC_features),
                    dtype=np.float32,
                )
            else:
                out[st] = [None] * num_examples
        i = 0
        for block in block_set:
            for trial in self._ecog_token_generator(block):
                for st in sequence_types:
                    seq = trial.get(st)
                    if seq is None:
                        continue
                    if isinstance(out[st], list):
                        out[st][i] = seq
                    else:
                        T = min(len(seq), self.max_samples)
                        if len(seq) > self.max_samples:
                            warnings.warn(
                                f"clipping trial {i} from {len(seq)} to "
                                f"{self.max_samples} samples"
                            )
                        out[st][i, :T] = seq[:T]
                i += 1
        return out

    # ---- TFRecord write path ---------------------------------------------

    def _write_to_Protobuf(self, block: int) -> None:
        """One writer per block; one Example per trial (reference
        data_generators.py:317-326)."""
        path = self.tf_record_path(block)
        self.vprint(f"writing {path}")
        with TFRecordWriter(path) as writer:
            for trial in self._ecog_token_generator(block):
                features = {
                    key: value
                    for key, value in trial.items()
                    if key in SEQUENCE_KEYS and value is not None
                }
                writer.write(encode_example(features))

    def write_to_Protobuf_maybe(
        self, sequence_type: str, block_set: Iterable[int]
    ) -> list[str]:
        """Write any missing block files, then read all records once to
        collect the unique target-token list as UTF-8 strings (reference
        data_generators.py:382-425; the reference's
        one-session-per-block read-back is collapsed into a single pass)."""
        block_set = list(block_set)
        for block in block_set:
            if not os.path.exists(self.tf_record_path(block)):
                self._write_to_Protobuf(block)
        unique: dict[str, None] = {}  # insertion-ordered set
        for block in block_set:
            for example in read_examples(self.tf_record_path(block)):
                for token in example.get(sequence_type, []):
                    if isinstance(token, bytes):
                        token = token.decode("utf-8")
                    unique.setdefault(str(token))
        return list(unique)


# --------------------------------------------------------------------------
# synthetic backend
# --------------------------------------------------------------------------

# A compact word inventory for synthetic sentences; letters map to
# pseudo-phonemes so the auxiliary phoneme head has real targets.
_SYNTH_WORDS = (
    "she sells sea shells by the shore a dog ran fast home we saw red "
    "birds fly over green hills today tim can read old books near tall "
    "trees his cat ate two fish then slept"
).split()

_LETTER_TO_PHONE = {
    "a": "AE", "b": "B", "c": "K", "d": "D", "e": "EH", "f": "F",
    "g": "G", "h": "HH", "i": "IH", "j": "JH", "k": "K", "l": "L",
    "m": "M", "n": "N", "o": "OW", "p": "P", "q": "K", "r": "R",
    "s": "S", "t": "T", "u": "UH", "v": "V", "w": "W", "x": "S",
    "y": "Y", "z": "Z",
}


def word_to_phonemes(word: str) -> list[str]:
    """Letter → pseudo-phoneme map, collapsing consecutive duplicates
    (double letters are one phoneme — also keeps the lexicon consistent
    with CTC's repeat-collapse of frame-aligned labels)."""
    out: list[str] = []
    for ch in word.lower():
        p = _LETTER_TO_PHONE.get(ch)
        if p is not None and (not out or out[-1] != p):
            out.append(p)
    return out


def _stable_seed(*parts: Any) -> int:
    """Process-independent seed from arbitrary parts (``hash()`` is
    randomized per interpreter, so record files would not reproduce)."""
    import hashlib

    digest = hashlib.md5(repr(parts).encode()).digest()
    return int.from_bytes(digest[:4], "little")


@register_data_generator(
    "SyntheticDataGenerator",
    # reference manifests name lab-private generators; route them here
    "SpeechDataGenerator",
    "BambooDataGenerator",
)
class SyntheticDataGenerator(ECoGDataGenerator):
    """Deterministic synthetic ECoG with sentence-dependent structure.

    Each word in the inventory owns a random-but-fixed spatial pattern
    per channel and a temporal envelope; a trial's ECoG is the
    concatenation of its words' patterns (plus noise), so a seq2seq
    model can drive WER→0.  Rayleigh-like nonnegative amplitudes mimic
    high-gamma analytic-amplitude features.

    Trial counts/sentences are derived deterministically from
    (seed, subject, block), so record files are reproducible.
    """

    def __init__(
        self,
        manifest: Manifest,
        subject_id: int | str,
        num_sentences_per_block: int | None = None,
        num_unique_sentences: int | None = None,
        words_per_sentence: tuple[int, int] | None = None,
        noise_scale: float | None = None,
        samples_per_word: int | None = None,
        seed: int | None = None,
        pattern_correlation: float | None = None,
        channel_dropout: float | None = None,
        **kwargs: Any,
    ):
        super().__init__(manifest, subject_id, **kwargs)
        # explicit kwarg > manifest > default (ctor args default to None
        # so a manifest value is never shadowed by the ctor default)
        self.num_sentences_per_block = int(
            manifest.resolve(
                "num_sentences_per_block", num_sentences_per_block, 10
            )
        )
        self.num_unique_sentences = int(
            manifest.resolve(
                "num_unique_training_sentences", num_unique_sentences, 10
            )
        )
        self.words_per_sentence = tuple(
            manifest.resolve("words_per_sentence", words_per_sentence, (3, 6))
        )
        self.noise_scale = float(
            manifest.resolve("synth_noise_scale", noise_scale, 0.05)
        )
        self.samples_per_word = int(
            manifest.resolve("samples_per_word", samples_per_word, 48)
        )
        self.seed = int(manifest.resolve("synth_seed", seed, 1234))
        # difficulty axis (a saturated-WER corpus cannot discriminate
        # decode modes).  pattern_correlation α blends every
        # word's spatial pattern toward one shared pattern — words become
        # confusable by construction, which noise alone cannot achieve
        # (the conv front end averages i.i.d. noise away).  channel_dropout
        # zeroes a random per-trial channel subset (electrode dropout).
        self.pattern_correlation = float(
            manifest.resolve(
                "synth_pattern_correlation", pattern_correlation, 0.0
            )
        )
        self.channel_dropout = float(
            manifest.resolve("synth_channel_dropout", channel_dropout, 0.0)
        )
        if not 0.0 <= self.pattern_correlation < 1.0:
            raise ValueError(
                "synth_pattern_correlation must be in [0, 1): "
                f"{self.pattern_correlation}"
            )
        if not 0.0 <= self.channel_dropout < 1.0:
            raise ValueError(
                "synth_channel_dropout must be in [0, 1): "
                f"{self.channel_dropout}"
            )
        self._blocks = list(manifest.resolve("blocks", default=list(range(1, 9))))

    # -- deterministic sentence inventory ----------------------------------

    @property
    def sentences(self) -> list[str]:
        rng = np.random.default_rng(self.seed)
        lo, hi = self.words_per_sentence
        out = []
        for _ in range(self.num_unique_sentences):
            n = int(rng.integers(lo, hi + 1))
            out.append(" ".join(rng.choice(_SYNTH_WORDS, size=n)))
        return out

    def _word_pattern(self, word: str) -> np.ndarray:
        """Fixed (samples_per_word, C) nonnegative pattern per word.
        ``pattern_correlation`` α pulls every word's spatial pattern
        toward one shared (word-independent) pattern: at α=0 words are
        independent Rayleigh draws; as α→1 they coincide and the task
        approaches chance."""
        C = self.num_ECoG_channels
        rng = np.random.default_rng(_stable_seed(self.seed, "pattern", word))
        spatial = rng.rayleigh(scale=1.0, size=(1, C))
        a = self.pattern_correlation
        if a > 0.0:
            shared_rng = np.random.default_rng(
                _stable_seed(self.seed, "pattern-shared")
            )
            shared = shared_rng.rayleigh(scale=1.0, size=(1, C))
            spatial = a * shared + (1.0 - a) * spatial
        t = np.linspace(0, np.pi, self.samples_per_word)[:, None]
        envelope = np.sin(t) + 0.25
        return (spatial * envelope).astype(np.float32)

    def _block_sentences(self, block: int) -> list[str]:
        sentences = self.sentences
        rng = np.random.default_rng(
            _stable_seed(self.seed, "block", int(self.subject_id), block)
        )
        idx = rng.integers(0, len(sentences), size=self.num_sentences_per_block)
        return [sentences[i] for i in idx]

    # -- subclass contract --------------------------------------------------

    def _query(self, block_set: Iterable[int]) -> int:
        return len(list(block_set)) * self.num_sentences_per_block

    def _get_wav_data(self, index: str) -> tuple[float, np.ndarray]:
        """Synthesized audio: one sine per word, freq keyed by word id."""
        words = index.split()
        rate = 16000
        segments = []
        for word in words:
            freq = 200.0 + 37.0 * (_stable_seed("freq", word) % 40)
            seg_t = np.arange(int(0.2 * rate)) / rate
            segments.append(np.sin(2 * np.pi * freq * seg_t))
        return rate, np.concatenate(segments) if segments else np.zeros(0)

    def _aligned_phonemes(self, words: list[str]) -> list[str]:
        """Frame-aligned per-sample phoneme labels (one label per ECoG
        sample): each word's phonemes split its ``samples_per_word``
        samples evenly.  This mirrors the reference's encoder targets,
        which are per-sample label sequences reversed+decimated to the
        encoder rate (reference trainers.py:789-799); CTC targets are
        derived by collapsing runs (pipeline.pack_partition)."""
        out: list[str] = []
        for word in words:
            phones = word_to_phonemes(word) or ["<OOV>"]
            bounds = np.linspace(
                0, self.samples_per_word, len(phones) + 1
            ).astype(int)
            for p, a, b in zip(phones, bounds[:-1], bounds[1:]):
                out.extend([p] * (b - a))
        return out

    def _ecog_token_generator(self, block: int) -> Iterator[dict[str, Any]]:
        noise_rng = np.random.default_rng(
            _stable_seed(self.seed, "noise", int(self.subject_id), block)
        )
        for sentence in self._block_sentences(block):
            words = sentence.split()
            ecog = np.concatenate([self._word_pattern(w) for w in words])
            ecog = ecog + self.noise_scale * noise_rng.rayleigh(
                scale=1.0, size=ecog.shape
            ).astype(np.float32)
            if self.channel_dropout > 0.0:
                keep = (
                    noise_rng.random(ecog.shape[1]) >= self.channel_dropout
                )
                ecog = ecog * keep[None, :].astype(np.float32)
            rate, signal = self._get_wav_data(sentence)
            if self.token_type == "phoneme_sequence":
                # phoneme_sequence as the DECODER target: the trial's
                # phoneme token sequence (one token per phoneme), not
                # the per-sample alignment the aux heads consume
                phonemes = [
                    p
                    for w in words
                    for p in (word_to_phonemes(w) or ["<OOV>"])
                ]
            else:
                phonemes = self._aligned_phonemes(words)
            yield {
                "ecog_sequence": ecog.astype(np.float32),
                "text_sequence": self._sentence_tokenize(sentence),
                "audio_sequence": self._get_MFCC_features(rate, signal),
                "phoneme_sequence": phonemes,
            }

    def _all_blocks(self) -> list[int]:
        return self._blocks

    # -- convenience for tests/demos ---------------------------------------

    def full_class_list(self) -> list[str]:
        """All tokens reachable from the sentence inventory, with special
        tokens prepended (EOS only for sequence token types — reference
        trainers.py:191-199)."""
        unique: dict[str, None] = {}
        for sentence in self.sentences:
            for token in self._sentence_tokenize(sentence):
                unique.setdefault(token)
        return with_special_tokens(
            list(unique), self.token_type.endswith("sequence")
        )

    def full_phoneme_list(self) -> list[str]:
        unique: dict[str, None] = {}
        for sentence in self.sentences:
            for word in sentence.split():
                for p in word_to_phonemes(word):
                    unique.setdefault(p)
        return with_special_tokens(list(unique))


@register_data_generator("ArrayDataGenerator", "FileDataGenerator")
class ArrayDataGenerator(ECoGDataGenerator):
    """File-backed generator: a directory of per-trial ``.npz``/``.mat``
    files — the zero-subclassing on-ramp for real lab data (VERDICT r2
    #8; the reference manifests name lab-PRIVATE generator classes,
    mocha-1_word_sequence.yaml:2-4, so any outside user previously had
    to implement the 3-method contract from scratch).

    Manifest/kwarg key ``trial_dir`` points at the root.  Layout::

        <trial_dir>/B<block>/<anything>.npz     (sorted within a block)
        <trial_dir>/B<block>_<anything>.npz     (flat alternative)

    Per-file keys (``.mat`` files use the same names):

    * ``ecog`` (T, C) float — pre-featurized frames at the manifest's
      ``sampling_rate``.  ``C`` may be the final per-channel feature
      count, or the FULL electrode count (``prod(grid_size)``; doubled
      for ``USE_FIELD_POTENTIALS``), in which case the grid's
      referencing (bad-electrode exclusion, layout ordering, bipolar
      differencing) is applied here.
    * ``raw`` (T_raw, C) float or int — RAW VOLTAGES, the alternative
      to ``ecog`` (exactly one of the two per file).  Featurized
      through :func:`features.extract_high_gamma` (notch → high-gamma
      band bank → Hilbert analytic amplitude → z-score → anti-aliased
      decimation to ``sampling_rate``) — the front end the reference
      delegates to lab-private generators (reference
      data_generators.py:487-530).  The raw rate comes from a per-file
      ``raw_rate`` scalar or the manifest/kwarg ``raw_sampling_rate``;
      grid referencing applies to the raw columns BEFORE featurization
      (referencing is linear, and bipolar differencing belongs at the
      voltage stage).  ``hg_zscore`` picks 'trial' (default — each
      trial z-scored over its own frames, the offline chain's native
      mode) or 'block' (per-channel stats pooled over the block's
      trials — the serving calibration seam,
      :func:`features.calibrate_high_gamma`); other chain knobs ride a
      ``high_gamma`` dict of :class:`features.HighGammaConfig` fields
      (band, num_bands, notch_freqs, pad_seconds, input_scale, …).
      The chain runs on ``device`` (kwarg or manifest key; CUDA by
      default, which raises without a GPU; ``"cpu"`` on purpose).
    * ``text`` — the sentence as a string (tokenized per the
      experiment's ``token_type``) or an already-tokenized list.
    * ``audio`` 1-D waveform + ``audio_rate`` scalar → featurized
      through the MFCC chain; or precomputed frames under
      ``audio_features`` (T, F).  Optional.
    * ``phonemes`` (T,) per-sample string labels.  Optional.
    """

    def __init__(
        self,
        manifest: Manifest,
        subject_id: int | str,
        trial_dir: str | None = None,
        device: str | None = None,
        **kwargs: Any,
    ):
        super().__init__(manifest, subject_id, **kwargs)
        self.trial_dir = manifest.resolve("trial_dir", trial_dir, None)
        # where raw trials are featurized; resolved at the first raw trial,
        # so a directory of featurized trials never needs a GPU
        self.device = manifest.resolve("device", device, "cuda")
        if not self.trial_dir:
            raise ValueError(
                "ArrayDataGenerator needs 'trial_dir' (manifest or kwarg)"
            )
        self.raw_sampling_rate = manifest.resolve(
            "raw_sampling_rate", kwargs.get("raw_sampling_rate"), None
        )
        self.hg_zscore = str(
            manifest.resolve("hg_zscore", kwargs.get("hg_zscore"), "trial")
        )
        if self.hg_zscore not in ("trial", "block"):
            raise ValueError(
                f"hg_zscore must be 'trial' or 'block': {self.hg_zscore!r}"
            )
        self._hg_overrides = dict(
            manifest.resolve("high_gamma", kwargs.get("high_gamma"), None)
            or {}
        )
        # per-block featurized-raw cache: (block, [features | None])
        self._hg_block_cache: tuple[int | None, list] = (None, [])

    # -- file discovery -----------------------------------------------------

    def _block_files(self, block: int) -> list[str]:
        exts = (".npz", ".mat")
        subdir = os.path.join(self.trial_dir, f"B{block}")
        if os.path.isdir(subdir):
            return sorted(
                os.path.join(subdir, f)
                for f in os.listdir(subdir)
                if f.endswith(exts)
            )
        prefix = f"B{block}_"
        if not os.path.isdir(self.trial_dir):
            return []
        return sorted(
            os.path.join(self.trial_dir, f)
            for f in os.listdir(self.trial_dir)
            if f.startswith(prefix) and f.endswith(exts)
        )

    def _all_blocks(self) -> list[int]:
        blocks: set[int] = set()
        if not os.path.isdir(self.trial_dir):
            return []
        for name in os.listdir(self.trial_dir):
            if name.startswith("B"):
                stem = name[1:].split("_")[0].split(".")[0]
                if stem.isdigit():
                    blocks.add(int(stem))
        return sorted(blocks)

    @staticmethod
    def _load_file(path: str) -> dict[str, Any]:
        if path.endswith(".mat"):
            from scipy.io import loadmat

            mat = loadmat(path, squeeze_me=True)
            return {
                k: v for k, v in mat.items() if not k.startswith("__")
            }
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files}

    # -- channel referencing ------------------------------------------------

    def _select_channels(self, ecog: np.ndarray) -> np.ndarray:
        """Apply grid referencing when the file carries full-electrode
        columns; pass through when it already matches the channel
        count.  Pass-through wins if the two counts coincide (possible
        in bipolar mode on square grids) — store pre-referenced data or
        pick a grid where they differ to disambiguate."""
        C = ecog.shape[1]
        if C == self.num_ECoG_channels:
            return ecog
        grid = self.grid
        m = grid.num_electrodes
        if self.REFERENCE_BIPOLAR:
            if C != m:
                raise ValueError(
                    f"{C} columns: bipolar referencing needs the full "
                    f"{m} electrode columns (or {self.num_ECoG_channels} "
                    "pre-referenced channels)"
                )
            pairs = grid.bipolar_to_elec_map
            return np.stack(
                [
                    ecog[:, pairs[i][0]] - ecog[:, pairs[i][1]]
                    for i in grid.good_channels
                ],
                axis=1,
            )
        expected = 2 * m if self.USE_FIELD_POTENTIALS else m
        if C != expected:
            raise ValueError(
                f"ecog has {C} columns; expected "
                f"{self.num_ECoG_channels} (per-channel) or {expected} "
                "(full electrode grid)"
            )
        return ecog[:, grid.good_channels]

    # -- raw-voltage featurization -------------------------------------------

    def high_gamma_config(self, raw_rate: float):
        """The trial-file featurization spec: manifest ``high_gamma``
        overrides on top of :class:`features.HighGammaConfig` defaults,
        output rate pinned to the manifest ``sampling_rate``."""
        from .features import HighGammaConfig

        kw = dict(self._hg_overrides)
        kw.setdefault(
            "zscore", "none" if self.hg_zscore == "block" else "trial"
        )
        return HighGammaConfig(
            raw_rate=float(raw_rate), out_rate=self.sampling_rate, **kw
        )

    def _featurize_raw(self, path: str, data: dict[str, Any]) -> np.ndarray:
        """One trial's ``raw`` columns → referenced, featurized frames
        (block z-scoring, if configured, happens in the block pass)."""
        from .features import extract_high_gamma_np

        raw = np.asarray(data["raw"])
        rate = data.get("raw_rate", self.raw_sampling_rate)
        if rate is None:
            raise ValueError(
                f"{path}: raw trials need a per-file 'raw_rate' scalar or "
                "the 'raw_sampling_rate' manifest/kwarg key"
            )
        cfg = self.high_gamma_config(float(np.asarray(rate)))
        if np.issubdtype(raw.dtype, np.integer):
            # scale BEFORE referencing: bipolar differences of int16
            # columns would overflow the integer dtype
            raw = raw.astype(np.float32) * cfg.input_scale
        return extract_high_gamma_np(
            self._select_channels(raw.astype(np.float32)), cfg, self.device
        )

    def _block_raw_features(self, block: int) -> list[np.ndarray | None]:
        """Featurized raw trials for one block (None where the file
        carries pre-featurized ``ecog``), with per-channel block stats
        applied in ``hg_zscore='block'`` mode.  Cached for the block
        being iterated — the block pass exists because block stats pool
        over every raw trial in the block."""
        if self._hg_block_cache[0] == block:
            return self._hg_block_cache[1]
        feats: list[np.ndarray | None] = []
        for path in self._block_files(block):
            data = self._load_file(path)
            if "ecog" in data or "raw" not in data:
                feats.append(None)
            else:
                feats.append(self._featurize_raw(path, data))
        if self.hg_zscore == "block":
            frames = [f for f in feats if f is not None and len(f)]
            if frames:
                stacked = np.concatenate(frames, axis=0)
                mu = stacked.mean(axis=0, keepdims=True)
                sd = np.maximum(stacked.std(axis=0, keepdims=True), 1e-6)
                feats = [
                    None if f is None else (f - mu) / sd for f in feats
                ]
        self._hg_block_cache = (block, feats)
        return feats

    # -- subclass contract --------------------------------------------------

    def _query(self, block_set: Iterable[int]) -> int:
        return sum(len(self._block_files(b)) for b in block_set)

    def _get_wav_data(self, index: str) -> tuple[float, np.ndarray]:
        """``index`` is a trial file path."""
        data = self._load_file(index)
        if "audio" in data:
            rate = float(np.asarray(data.get("audio_rate", 16000)))
            return rate, np.asarray(data["audio"], np.float32).ravel()
        return self.sampling_rate, np.zeros(0, np.float32)

    def _ecog_token_generator(self, block: int) -> Iterator[dict[str, Any]]:
        for i, path in enumerate(self._block_files(block)):
            data = self._load_file(path)
            if "ecog" in data:
                ecog = self._select_channels(
                    np.asarray(data["ecog"], np.float32)
                )
            elif "raw" in data:
                ecog = (
                    self._block_raw_features(block)[i]
                    if self.hg_zscore == "block"
                    else self._featurize_raw(path, data)
                )
            else:
                raise KeyError(
                    f"{path}: needs an 'ecog' (featurized) or 'raw' "
                    "(voltage) array"
                )
            text = data.get("text")
            if text is None:
                tokens: list[str] = []
            elif isinstance(text, str) or (
                isinstance(text, np.ndarray) and text.ndim == 0
            ):
                tokens = self._sentence_tokenize(str(text))
            else:
                tokens = [
                    t.decode("utf-8") if isinstance(t, bytes) else str(t)
                    for t in np.asarray(text).ravel()
                ]
            if "audio_features" in data:
                audio = np.asarray(data["audio_features"], np.float32)
            elif "audio" in data:
                rate, signal = self._get_wav_data(path)
                audio = self._get_MFCC_features(rate, signal)
            else:
                audio = np.zeros((0, self.num_MFCC_features), np.float32)
            phonemes = None
            if "phonemes" in data:
                phonemes = [
                    p.decode("utf-8") if isinstance(p, bytes) else str(p)
                    for p in np.asarray(data["phonemes"]).ravel()
                ]
            yield {
                "ecog_sequence": ecog,
                "text_sequence": tokens,
                "audio_sequence": audio,
                "phoneme_sequence": phonemes,
            }


def export_trials_to_arrays(
    generator: ECoGDataGenerator,
    out_dir: str,
    blocks: Iterable[int] | None = None,
) -> int:
    """Export a generator's trials as per-trial ``.npz`` files in the
    :class:`ArrayDataGenerator` layout (``<out_dir>/B<block>/NNNN.npz``
    with already-tokenized text and featurized audio) — round-trip
    helper and migration path.  Returns the number of trials written."""
    count = 0
    for block in blocks if blocks is not None else generator._all_blocks():
        block_dir = os.path.join(out_dir, f"B{block}")
        os.makedirs(block_dir, exist_ok=True)
        for i, trial in enumerate(generator._ecog_token_generator(block)):
            arrays = {"ecog": np.asarray(trial["ecog_sequence"], np.float32)}
            if trial.get("text_sequence") is not None:
                arrays["text"] = np.asarray(trial["text_sequence"])
            if trial.get("audio_sequence") is not None:
                arrays["audio_features"] = np.asarray(
                    trial["audio_sequence"], np.float32
                )
            if trial.get("phoneme_sequence") is not None:
                arrays["phonemes"] = np.asarray(trial["phoneme_sequence"])
            np.savez(os.path.join(block_dir, f"{i:04d}.npz"), **arrays)
            count += 1
    return count


def filter_to_common_targets(inputs_A, targets_A, inputs_B, targets_B):
    """Drop examples whose target occurs in only one of two sets
    (reference data_generators.py:535-549; marked deprecated there but
    kept for API completeness).  ``inputs_*`` are (N, T, C) arrays,
    ``targets_*`` parallel lists; returns the four filtered objects."""
    common = set(map(_hashable, targets_A)) & set(map(_hashable, targets_B))
    inputs_A, targets_A = filter_to_common_targets_core(
        inputs_A, targets_A, common
    )
    inputs_B, targets_B = filter_to_common_targets_core(
        inputs_B, targets_B, common
    )
    print(
        "Sets (A,B) now have (%d,%d) examples and (%d,%d) unique tokens"
        % (
            len(targets_A), len(targets_B),
            len(set(map(_hashable, targets_A))),
            len(set(map(_hashable, targets_B))),
        )
    )
    return inputs_A, targets_A, inputs_B, targets_B


def filter_to_common_targets_core(inputs, targets, common_targets):
    """Core of :func:`filter_to_common_targets` (reference
    data_generators.py:551-562): keep indices whose target is in
    ``common_targets``; inputs are a numpy array, targets a list."""
    keep = [
        i for i, val in enumerate(targets)
        if _hashable(val) in common_targets
    ]
    return inputs[keep], [targets[i] for i in keep]


def _hashable(target):
    """Targets may be strings or lists of tokens (list-of-lists case in
    the reference docstring); make them set-compatible."""
    return tuple(target) if isinstance(target, list) else target


set_fallback_generator("SyntheticDataGenerator")
