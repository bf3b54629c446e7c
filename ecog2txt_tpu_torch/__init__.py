"""ecog2txt_tpu_torch — the PyTorch / CUDA (Hopper) port of ecog2txt_tpu.

A package of its own beside the JAX package, which stays the reference
the port is held against.  It imports ``torch``, numpy, scipy and yaml:
nothing of JAX and nothing of ``ecog2txt_tpu``, so the modules and
constants it shares with the JAX package are copied here under the same
names.

Package layout (the slices ported so far):
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
    utils       — checkpoint introspection, TensorBoard summaries, the
                  import of the reference's TF1 checkpoints

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
