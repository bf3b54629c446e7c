"""Online inference: the predictor and the utterance-level streaming
session of the biLSTM model.

``OnlinePredictor`` pads each request to a fixed ``max_samples`` window,
greedy-decodes it, then teacher-forces the hypothesis to get each
emitted token's probability — the same call contract and return dict as
the JAX package's predictor.  ``StreamingSession`` buffers raw chunks as
they arrive and decodes the utterance on demand (the biLSTM reads its
input reversed, so it is utterance-level by nature).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from . import resolve_device
from .convert import load_checkpoint, tree_map
from .models.seq2seq import (
    Seq2SeqConfig,
    decoder_teacher_forcing,
    encode,
    greedy_decode,
)
from .tokenizers import target_inds_to_sequences


class OnlinePredictor:
    """Single/multi-trial predictor over a fixed padded window."""

    def __init__(
        self,
        params,
        config: Seq2SeqConfig,
        targets_list: Sequence[str],
        max_samples: int = 1248,
        subject_idx: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.config = config
        self.targets_list = list(targets_list)
        self.max_samples = int(max_samples)
        self.subject_idx = int(subject_idx)

    @classmethod
    def from_trainer(cls, trainer, use_ema: bool = True, **kwargs):
        """Serve a ``train.MultiSubjectTrainer``'s (EMA) weights for its
        target subject, on the trainer's device unless ``device`` is
        given."""
        params = trainer.state.ema if use_ema else trainer.state.params
        dec_list = trainer.target_subject.data_manifests[
            "decoder_targets"
        ].feature_list
        kwargs.setdefault("device", trainer.device)
        return cls(
            params,
            trainer.net_config,
            dec_list,
            max_samples=trainer.target_subject.data_generator.max_samples,
            subject_idx=len(trainer.ecog_subjects) - 1,
            **kwargs,
        )

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        config: Seq2SeqConfig,
        targets_list: Sequence[str],
        device="cuda",
        **kwargs,
    ):
        """Serve the EMA weights of a ``convert.save_checkpoint`` file."""
        state = load_checkpoint(path, device)
        return cls(state["ema"], config, targets_list, device=device, **kwargs)

    @torch.inference_mode()
    def _predict(self, inputs: torch.Tensor, lengths: torch.Tensor):
        params, config = self.params, self.config
        tokens = greedy_decode(
            params, config, inputs, lengths, self.subject_idx, temperature=0.0
        )
        # per-step probabilities of the emitted tokens under teacher
        # forcing on the hypothesis
        enc_out, enc_final, enc_lengths = encode(
            params, config, inputs, lengths, self.subject_idx
        )
        logits = decoder_teacher_forcing(
            params, config, enc_final, tokens,
            enc_out=enc_out, enc_lengths=enc_lengths,
        )  # (L, B, V)
        probs = torch.softmax(logits, dim=-1)
        tok_probs = torch.gather(
            probs, -1, tokens.long().transpose(0, 1)[..., None]
        )[..., 0]
        return tokens, tok_probs.transpose(0, 1)

    def __call__(self, inputs: np.ndarray) -> dict:
        """``inputs``: (T, C) single trial or (B, T, C) batch.  Returns
        {'sequences': [str], 'tokens': (B, L), 'probabilities': (B, L)}.
        """
        inputs = np.asarray(inputs, np.float32)
        if inputs.ndim == 2:
            inputs = inputs[None]
        B, T, C = inputs.shape
        Cp = self.config.in_channels
        if C > Cp:
            # silently truncating extra channels would decode garbage
            raise ValueError(
                f"inputs have {C} channels; the model was built for "
                f"{Cp} (pad-to-max across subjects). Pass the model's "
                "channel layout."
            )
        padded = np.zeros((B, self.max_samples, Cp), np.float32)
        padded[:, : min(T, self.max_samples), :C] = inputs[:, : self.max_samples]
        lengths = np.full((B,), min(T, self.max_samples), np.int32)
        tokens, probs = self._predict(
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        tokens = tokens.cpu().numpy()
        return {
            "tokens": tokens,
            "probabilities": probs.float().cpu().numpy(),
            "sequences": target_inds_to_sequences(tokens, self.targets_list),
        }


def construct_online_predictor(
    restore_path: str,
    targets_list: Sequence[str],
    config: Seq2SeqConfig,
    TARGETS_ARE_SEQUENCES: bool = True,
    **kwargs,
) -> Callable[[np.ndarray], list[str]]:
    """Reference-parity factory: a ``predict(inputs) -> sentences``
    closure over a checkpoint's EMA weights."""
    predictor = OnlinePredictor.from_checkpoint(
        restore_path, config, targets_list, **kwargs
    )

    def predict(inputs: np.ndarray) -> list[str]:
        return predictor(inputs)["sequences"]

    return predict


class StreamingSession:
    """Chunked-arrival inference over a buffer of raw ECoG.

    ``push(chunk)`` appends (T_chunk, C) samples; ``decode()`` runs the
    predictor over the current utterance buffer; ``endpoint()`` decodes
    and resets for the next utterance."""

    def __init__(self, predictor: OnlinePredictor):
        self.predictor = predictor
        self._buffer: list[np.ndarray] = []
        self._samples = 0

    @property
    def num_samples(self) -> int:
        return self._samples

    def push(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2:
            raise ValueError("chunk must be (T, C)")
        space = self.predictor.max_samples - self._samples
        if space <= 0:
            return  # utterance cap reached (the reference clips, too)
        chunk = chunk[:space]
        self._buffer.append(chunk)
        self._samples += len(chunk)

    def decode(self) -> dict:
        if not self._buffer:
            return {"sequences": [""], "tokens": None, "probabilities": None}
        utterance = np.concatenate(self._buffer, axis=0)
        return self.predictor(utterance)

    def endpoint(self) -> dict:
        out = self.decode()
        self.reset()
        return out

    def reset(self) -> None:
        self._buffer = []
        self._samples = 0
