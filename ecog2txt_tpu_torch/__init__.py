"""ecog2txt_tpu_torch — the PyTorch / CUDA (Hopper) port of ecog2txt_tpu.

A package of its own beside the JAX package, which stays the reference
the port is held against.  It imports ``torch``, numpy, scipy and yaml:
nothing of JAX and nothing of ``ecog2txt_tpu``, so the modules and
constants it shares with the JAX package are copied here under the same
names.

Package layout:
    config      — experiment manifests (YAML) + block breakdowns (JSON)
    geometry    — electrode grid layouts, channel referencing
    audio       — mel-filterbank / MFCC featurization
    tokenizers  — tokenization, vocab files, detokenization
    records     — TFRecord container + tf.train.Example codec
    datagen     — ECoGDataGenerator contract + synthetic generator
    subjects    — ECoGSubject, SequenceDataManifest
    pipeline    — records → padded, stacked corpus arrays + schedules; lazy
                  and sliced shards, the prefetch worker
    demo        — a synthetic demo experiment on disk
    ops         — LSTM scans + the hand-written Hopper kernels (LSTM
                  recurrences, banded attention, LayerNorm)
    models      — seq2seq encoder-decoder (biLSTM and conformer families),
                  beam search, the CTC head and its lexicon search
    train       — MultiSubjectTrainer, segment runner, EMA, assessment,
                  transfer curricula, scope masks, schedules, the trainer's
                  inspection and analysis tools
    assess      — WER / accuracy / confusions
    convert     — parameter trees across the two packages, checkpoints
    serve       — online predictor and its export, the streaming sessions
                  and the streaming pool
    features    — raw-voltage featurization (high gamma), offline and streamed
    quantize    — int8 conformer serving
    parallel    — data, sequence, expert, tensor and pipeline parallelism over
                  torch.distributed
    experiments — training-size and grid-search sweeps
    plotting    — results archives, electrode contributions, figures
    utils       — checkpoint introspection, TensorBoard summaries, the
                  import of the reference's TF1 checkpoints, step timing, FLOPs
    run_demo    — the demo: experiment → train → assess → analyse → serve
    examples    — the other user entry points of ``examples/`` (``python -m
                  ecog2txt_tpu_torch.examples.<name>``)

The constants below are the JAX package's: special tokens, token types,
data partitions and the phonetic feature tables.

Entry points that create tensors default to ``device="cuda"`` and raise
when no GPU is present unless the caller asks for the CPU explicitly.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

# Directory of the packaged vocab files and manifests (a copy of the JAX
# package's auxiliary/).
text_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "auxiliary")

# Special tokens (the same strings as the JAX package's constants).
EOS_token = "<EOS>"
pad_token = "<pad>"
OOV_token = "<OOV>"
SPECIAL_TOKENS = (pad_token, EOS_token, OOV_token)

# Recognised token types.
TOKEN_TYPES = (
    "phoneme",
    "word",
    "trial",
    "word_sequence",
    "word_piece_sequence",
    "phoneme_sequence",
)

# Dataset partitions.
DATA_PARTITIONS = ("training", "validation", "testing")

# Phonetic feature tables: the rows of the JAX package's ``consonant_df``
# and ``vowel_df`` as plain tuples, so that importing the port needs no
# pandas.  Index = IPA symbol.  Consonants: voicing / place / manner and
# the ARPABET code (the IPA chart for General American English).
_CONSONANT_COLUMNS = ("voiced", "place", "manner", "arpabet")
_CONSONANTS = {
    "p": (False, "bilabial", "plosive", "P"),
    "b": (True, "bilabial", "plosive", "B"),
    "t": (False, "alveolar", "plosive", "T"),
    "d": (True, "alveolar", "plosive", "D"),
    "k": (False, "velar", "plosive", "K"),
    "g": (True, "velar", "plosive", "G"),
    "tʃ": (False, "postalveolar", "affricate", "CH"),
    "dʒ": (True, "postalveolar", "affricate", "JH"),
    "f": (False, "labiodental", "fricative", "F"),
    "v": (True, "labiodental", "fricative", "V"),
    "θ": (False, "dental", "fricative", "TH"),
    "ð": (True, "dental", "fricative", "DH"),
    "s": (False, "alveolar", "fricative", "S"),
    "z": (True, "alveolar", "fricative", "Z"),
    "ʃ": (False, "postalveolar", "fricative", "SH"),
    "ʒ": (True, "postalveolar", "fricative", "ZH"),
    "h": (False, "glottal", "fricative", "HH"),
    "m": (True, "bilabial", "nasal", "M"),
    "n": (True, "alveolar", "nasal", "N"),
    "ŋ": (True, "velar", "nasal", "NG"),
    "l": (True, "alveolar", "lateral", "L"),
    "ɹ": (True, "alveolar", "approximant", "R"),
    "w": (True, "bilabial", "approximant", "W"),
    "j": (True, "palatal", "approximant", "Y"),
}
# Monophthongs: mean adult-male F1 / F2 in Hz (Hillenbrand, Getty, Clark
# & Wheeler 1995) and the ARPABET code.
_VOWEL_COLUMNS = ("F1", "F2", "arpabet")
_VOWELS = {
    "i": (342, 2322, "IY"),
    "ɪ": (427, 2034, "IH"),
    "e": (476, 2089, "EY"),
    "ɛ": (580, 1799, "EH"),
    "æ": (588, 1952, "AE"),
    "ɑ": (768, 1333, "AA"),
    "ɔ": (652, 997, "AO"),
    "o": (497, 910, "OW"),
    "ʊ": (469, 1122, "UH"),
    "u": (378, 997, "UW"),
    "ʌ": (623, 1200, "AH"),
    "ɝ": (474, 1379, "ER"),
}
_PHONETIC_TABLES = {
    "consonant_df": (_CONSONANTS, _CONSONANT_COLUMNS),
    "vowel_df": (_VOWELS, _VOWEL_COLUMNS),
}

# The ARPABET inventory of both tables, sorted.
ARPABET_PHONEMES = tuple(
    sorted({row[-1] for rows, _ in _PHONETIC_TABLES.values() for row in rows.values()})
)


def phoneme_features(arpabet: str) -> dict:
    """The features of one ARPABET phoneme: its row of the consonant
    table, else of the vowel table, as ``{column: value}``; ``KeyError``
    for a phoneme in neither."""
    for rows, columns in _PHONETIC_TABLES.values():
        for row in rows.values():
            if row[-1] == arpabet:
                return dict(zip(columns, row))
    raise KeyError(f"unknown phoneme {arpabet!r}")


def __getattr__(name: str):
    """``consonant_df`` and ``vowel_df``: the tables as pandas DataFrames,
    built on first access (pandas is imported here, and only here)."""
    if name not in _PHONETIC_TABLES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import pandas as pd

    rows, columns = _PHONETIC_TABLES[name]
    table = globals()[name] = pd.DataFrame.from_dict(rows, orient="index",
                                                      columns=list(columns))
    return table


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``device`` argument of an entry point as a ``torch.device``.

    A CUDA device without a usable GPU raises ``RuntimeError``: the port
    never drops to the CPU on its own.  Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on purpose.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
