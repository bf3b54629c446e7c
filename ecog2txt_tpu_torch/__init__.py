"""ecog2txt_tpu_torch — the PyTorch / CUDA (Hopper) port of ecog2txt_tpu.

A package of its own beside the JAX package, which stays the reference
the port is held against.  It imports ``torch`` and numpy only: nothing
of JAX and nothing of ``ecog2txt_tpu``, so the few constants it shares
with the JAX package are copied here.

Package layout (the slices ported so far):
    tokenizers  — index → sentence detokenization
    ops         — LSTM scans + the hand-written Hopper recurrence kernel
    models      — seq2seq encoder-decoder, LSTM family, inference half
    convert     — parameter trees across the two packages, checkpoints
    serve       — online predictor and streaming session

Entry points that create tensors default to ``device="cuda"`` and raise
when no GPU is present unless the caller asks for the CPU explicitly.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Special tokens (the same strings as the JAX package's constants).
EOS_token = "<EOS>"
pad_token = "<pad>"
OOV_token = "<OOV>"
SPECIAL_TOKENS = (pad_token, EOS_token, OOV_token)


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
