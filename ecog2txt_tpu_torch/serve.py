"""Online and streaming inference.

The twin of ``ecog2txt_tpu/serve.py``:

* :class:`OnlinePredictor` pads each request to a fixed ``max_samples``
  window, greedy-decodes it, then teacher-forces the hypothesis to get
  each emitted token's probability; :class:`StreamingSession` buffers raw
  chunks and decodes the utterance on demand (the biLSTM reads its input
  reversed, so it is utterance-level by nature);
* :func:`export_predictor` writes a predictor as a ``torch.export``
  program with the weights baked in and a symbolic batch dimension;
  :func:`load_exported_predictor` serves it.  The kernels the program
  reaches are operators of this package (``torch.library.custom_op``), so
  loading it needs ``ecog2txt_tpu_torch`` importable, where the JAX
  package's StableHLO artifact needs only a JAX install;
* :class:`StreamingConformerSession` encodes a conformer model's input
  as it arrives: whole raw chunks of ``decimation_factor × chunk_size``
  samples go through the subject's conv (width == stride, so chunks
  convolve independently) and the bounded-window
  :class:`models.conformer.ConformerStream`; ``decode()`` flushes the
  remainder speculatively and decodes, and the streamed tokens equal the
  offline ``greedy_decode`` of the padded utterance; ``partial()`` gives
  live CTC hypotheses, greedy or lexicon-constrained;
* :class:`StreamingSessionPool` serves up to ``capacity`` such streams,
  each with its own clock, through one batched conv and one batched window
  encode a tick (per-row position offsets and lengths; the plain 'dense'
  or 'banded' attention, as the JAX package pins them).

Raw blocks reach the device through a host staging buffer (pinned for a
CUDA device) in bfloat16 under bf16 compute (the conv casts its input to
the compute dtype first, so this is bit-identical), or as int8 with
per-channel scales under ``host_upload='int8'``.  ``quantize='int8'``
rewrites the conformer encoder's weights to int8 (``quantize.py``; the
products then run int8 x int8 → int32, and 'fused' attention gives way
to 'flash', the same function).  :class:`RawVoltageSession` puts the
high-gamma front end (``features.StreamingHighGamma``) in front of a
session, so digitizer chunks go in and text comes out.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import resolve_device
from .convert import load_checkpoint, tree_map
from .features import StreamingHighGamma
from .models.conformer import (
    _AUTO_DENSE_MAX_STEPS,
    ConformerConfig,
    ConformerStream,
    conformer_encode,
    receptive_field_steps,
)
from .models.ctc import CTCWordBeamState, collapse_alignment
from .models.seq2seq import (
    Seq2SeqConfig,
    _dense,
    convolve_sequences,
    decode_from_encoder,
    decoder_teacher_forcing,
    encode,
    greedy_decode,
)
from .quantize import is_quantized, quantize_conformer_params
from .tokenizers import target_inds_to_sequences

_HOST_UPLOAD_MODES = (None, "int8")


def _maybe_quantize(params, quantize: str | None):
    """The serving-time int8 rewrite of the conformer encoder subtree
    (``quantize.quantize_conformer_params``), once: a tree that holds int8
    weights already is returned as it is."""
    if quantize is None:
        return params
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
    if is_quantized(params):
        return params
    return quantize_conformer_params(params)


def _host_input_dtype(config: Seq2SeqConfig) -> torch.dtype:
    """Host-buffer dtype for raw-ECoG uploads on the streaming paths.

    ``convolve_sequences`` casts its input to ``compute_dtype`` as its
    first operation, so casting on the host is bit-identical (f32 → bf16
    rounds to nearest even on either side) and halves the bytes sent."""
    return torch.bfloat16 if config.compute_dtype == torch.bfloat16 else torch.float32


def _quantize_host_block(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, T, C) f32 → (int8 block, (B, C) f32 scales): symmetric
    per-row-per-channel quantization over the block's T samples.

    The opt-in ``host_upload='int8'`` path: 2× fewer bytes than bf16, but
    LOSSY, so the contract becomes streamed == offline on the same
    int8-dequantized inputs; the rounding is at most 1/254 of each
    channel's amplitude in the block."""
    amax = np.abs(raw).max(axis=1)  # (B, C)
    scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.round(raw / scales[:, None, :]), -127, 127).astype(np.int8)
    return q, scales


class _HostStaging:
    """A host buffer of one shape and dtype (pinned for a CUDA device) and
    its copies to the device.  Before the buffer is written again, the
    previous copy out of it is waited for, so one buffer serves every
    upload."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        self.buffer = torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")
        self.device = device
        self._copied = None  # CUDA event after the last copy out

    def upload(self, array: np.ndarray) -> torch.Tensor:
        if self._copied is not None:
            self._copied.synchronize()
        self.buffer.copy_(torch.from_numpy(array))  # the host-side cast
        out = self.buffer.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return out


def _predict(params, config: Seq2SeqConfig, subject_idx: int, inputs, lengths):
    """Greedy tokens (B, L) and each emitted token's probability under
    teacher forcing on the hypothesis (B, L)."""
    tokens = greedy_decode(params, config, inputs, lengths, subject_idx, temperature=0.0)
    enc_out, enc_final, enc_lengths = encode(params, config, inputs, lengths, subject_idx)
    logits = decoder_teacher_forcing(
        params, config, enc_final, tokens, enc_out=enc_out, enc_lengths=enc_lengths,
    )  # (L, B, V)
    probs = torch.softmax(logits, dim=-1)
    tok_probs = torch.gather(probs, -1, tokens.long().transpose(0, 1)[..., None])[..., 0]
    return tokens, tok_probs.transpose(0, 1)


def _pad_request(inputs, max_samples: int, channels: int, what: str):
    """A request as (B, max_samples, channels) f32 and its lengths (B,)."""
    inputs = np.asarray(inputs, np.float32)
    if inputs.ndim == 2:
        inputs = inputs[None]
    B, T, C = inputs.shape
    if C > channels:
        # silently truncating extra channels would decode garbage
        raise ValueError(
            f"inputs have {C} channels; {what} {channels} (pad-to-max across "
            "subjects). Pass the model's channel layout."
        )
    padded = np.zeros((B, max_samples, channels), np.float32)
    padded[:, : min(T, max_samples), :C] = inputs[:, :max_samples]
    return padded, np.full((B,), min(T, max_samples), np.int32)


def _response(tokens: torch.Tensor, probs: torch.Tensor, targets_list) -> dict:
    tokens = tokens.cpu().numpy()
    return {
        "tokens": tokens,
        "probabilities": probs.float().cpu().numpy(),
        "sequences": target_inds_to_sequences(tokens, targets_list),
    }


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
        params = trainer.full_params(use_ema)
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
        return _predict(self.params, self.config, self.subject_idx, inputs, lengths)

    def __call__(self, inputs: np.ndarray) -> dict:
        """``inputs``: (T, C) single trial or (B, T, C) batch.  Returns
        {'sequences': [str], 'tokens': (B, L), 'probabilities': (B, L)}.
        """
        padded, lengths = _pad_request(
            inputs, self.max_samples, self.config.in_channels, "the model was built for"
        )
        tokens, probs = self._predict(
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        return _response(tokens, probs, self.targets_list)


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


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

_EXPORT_PROGRAM = "predictor.pt2"
_EXPORT_META = "predictor_meta.json"
_EXPORT_FORMAT = "ecog2txt_tpu_torch.exported_predictor/1"
_EXPORT_MAX_BATCH = 4096  # the symbolic batch dimension's upper bound


class _PredictProgram(torch.nn.Module):
    """A predictor's call as a module whose buffers are its weights, so
    that ``torch.export`` bakes them into the program."""

    def __init__(self, predictor: OnlinePredictor):
        super().__init__()
        leaves, self._spec = tree_flatten(predictor.params)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"w{i}", leaf)
        self._n = len(leaves)
        self._config = predictor.config
        self._subject_idx = predictor.subject_idx

    def forward(self, inputs: torch.Tensor, lengths: torch.Tensor):
        params = tree_unflatten([getattr(self, f"w{i}") for i in range(self._n)], self._spec)
        return _predict(params, self._config, self._subject_idx, inputs, lengths)


def export_predictor(predictor: OnlinePredictor, path: str) -> str:
    """Serialize ``predictor`` into a serving artifact: a ``torch.export``
    program (``predictor.pt2``) with the weights baked in, beside
    ``predictor_meta.json``.

    The batch dimension is symbolic (1 to 4096), time fixed at the
    predictor's ``max_samples`` window, as :meth:`OnlinePredictor.__call__`
    pads it.  The program runs on the predictor's device.  Its kernels are
    operators of this package (``torch.library.custom_op``: K1f / K4f on
    the biLSTM, K2f / K3f and K5f on the conformer), so the program calls
    the hand-written kernels, and loading it needs ``ecog2txt_tpu_torch``
    importable to register them.  Returns ``path``."""
    module = _PredictProgram(predictor)
    dev = predictor.device
    example = (
        torch.zeros((2, predictor.max_samples, predictor.config.in_channels), device=dev),
        torch.full((2,), predictor.max_samples, dtype=torch.int32, device=dev),
    )
    batch = torch.export.Dim("batch", min=1, max=_EXPORT_MAX_BATCH)
    with torch.no_grad():
        program = torch.export.export(
            module, example, dynamic_shapes=({0: batch}, {0: batch})
        )
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _EXPORT_PROGRAM))
    meta = {
        "format": _EXPORT_FORMAT,
        "targets_list": list(predictor.targets_list),
        "max_samples": predictor.max_samples,
        "in_channels": int(predictor.config.in_channels),
        "platforms": [dev.type],
        "jax_version": None,  # the artifact holds no JAX
        "torch_version": torch.__version__,
        "outputs": ["tokens (B, L) int32", "token probabilities (B, L) f32"],
    }
    with open(os.path.join(path, _EXPORT_META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class ExportedPredictor:
    """Serving-side loader for :func:`export_predictor` artifacts: the
    call contract of :class:`OnlinePredictor` (pad or clip to the exported
    window, the channel check, detokenized sentences) over the loaded
    program, on the device it was exported for."""

    def __init__(self, path: str):
        with open(os.path.join(path, _EXPORT_META)) as f:
            self.meta = json.load(f)
        fmt = self.meta.get("format", "")
        if not fmt.startswith("ecog2txt_tpu_torch.exported_predictor/"):
            raise ValueError(f"not an exported-predictor artifact: {path}")
        self.device = resolve_device(self.meta["platforms"][0])
        self.program = torch.export.load(os.path.join(path, _EXPORT_PROGRAM))
        self._module = self.program.module()
        self.targets_list = list(self.meta["targets_list"])
        self.max_samples = int(self.meta["max_samples"])
        self.in_channels = int(self.meta["in_channels"])

    def __call__(self, inputs: np.ndarray) -> dict:
        padded, lengths = _pad_request(
            inputs, self.max_samples, self.in_channels, "the artifact was exported for"
        )
        with torch.inference_mode():
            tokens, probs = self._module(
                torch.from_numpy(padded).to(self.device),
                torch.from_numpy(lengths).to(self.device),
            )
        return _response(tokens, probs, self.targets_list)


def load_exported_predictor(path: str) -> ExportedPredictor:
    """Load an :func:`export_predictor` artifact (``ecog2txt_tpu_torch``
    must be importable: its operators are the program's kernels)."""
    return ExportedPredictor(path)


# --------------------------------------------------------------------------
# the biLSTM's utterance-level stream
# --------------------------------------------------------------------------


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


# --------------------------------------------------------------------------
# the conformer's incremental stream and the pool
# --------------------------------------------------------------------------


def _ctc_head_apply(params, config, head_name, enc_block, want_logp):
    """(B, n, D) encoder block → per-step argmax path (n, B) int (plus
    (n, B, K+1) f32 log-probs when ``want_logp``) through the CTC aux
    head, with the training head's numerics (``_dense``: f32
    accumulation).  Shared by the session and the pool; log-probs reach
    the host only when the lexicon path needs them."""
    head = params["aux"][head_name]
    cd = config.compute_dtype
    h = enc_block.transpose(0, 1)  # (n, B, D)
    for mlp in head["mlp"]:
        h = torch.relu(_dense(mlp, h, cd))
    logits = _dense(head["out"], h, cd).float()
    path = torch.argmax(logits, dim=-1).cpu().numpy()
    if not want_logp:
        return path, None
    return path, torch.log_softmax(logits, dim=-1).cpu().numpy()


def _decode_pooled_encoder(params, config, targets_list, enc_bm, valid_steps: int) -> dict:
    """Shared decode tail of the session and the pool: the mean over the
    valid steps (all of ``enc_bm``'s) as the decoder's initial state, as
    the offline conformer bridge in ``models.seq2seq.encode``, then the
    free-running greedy decode.  ``encoder_outputs`` come back as f32."""
    B = enc_bm.shape[0]
    lengths = torch.full((B,), valid_steps, dtype=torch.int32, device=enc_bm.device)
    pooled = enc_bm.sum(dim=1) / torch.clamp(lengths[:, None], min=1).to(enc_bm.dtype)
    tokens = decode_from_encoder(
        params, config, enc_bm.transpose(0, 1), (pooled, pooled), lengths, temperature=0.0,
    ).cpu().numpy()
    return {
        "tokens": tokens,
        "encoder_outputs": enc_bm.float().cpu().numpy(),
        "sequences": target_inds_to_sequences(tokens, targets_list),
    }


def _ctc_phonemes(path: np.ndarray, blank: int, phoneme_list) -> list:
    """One row's best path → collapsed phoneme labels (ids without a
    phoneme list)."""
    seq = [int(i) for i in collapse_alignment(path) if i != blank]
    return [phoneme_list[i] for i in seq] if phoneme_list is not None else seq


class _ConformerServing:
    """What the session and the pool share: the checks, the weights on the
    device, the CTC head, and the raw block → conv features upload."""

    def __init__(self, params, config, targets_list, subject_idx, phoneme_list,
                 quantize, host_upload, device, what: str):
        if config.encoder_type != "conformer":
            raise ValueError(f"{what} requires encoder_type='conformer'")
        if host_upload not in _HOST_UPLOAD_MODES:
            raise ValueError(
                f"unknown host_upload mode {host_upload!r} (supported: {_HOST_UPLOAD_MODES})"
            )
        self._host_upload = host_upload
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), _maybe_quantize(params, quantize))
        self.config = config
        self.targets_list = list(targets_list)
        self.ccfg = config.conformer or ConformerConfig()
        self.subject_idx = int(subject_idx)
        self.samples_per_chunk = config.decimation_factor * self.ccfg.chunk_size
        self.phoneme_list = list(phoneme_list) if phoneme_list else None
        ctc = next((h for h in config.aux_heads if h.distribution == "CTC"), None)
        self._ctc_head = ctc.name if ctc is not None else None
        if self.phoneme_list is not None and ctc is not None:
            # out_dim counts the phoneme classes and the trailing blank
            if len(self.phoneme_list) != ctc.out_dim - 1:
                raise ValueError(
                    f"phoneme_list has {len(self.phoneme_list)} entries; "
                    f"CTC head {ctc.name!r} expects {ctc.out_dim - 1} "
                    f"(out_dim {ctc.out_dim} minus the blank)"
                )
        self._staging: dict = {}

    @classmethod
    def from_trainer(cls, trainer, use_ema: bool = True, **kwargs):
        """Build from a live ``train.MultiSubjectTrainer``: EMA (or raw)
        weights, the decoder vocab, the target subject's subnet index, the
        trainer's device unless ``device`` is given, and, when the config
        has a CTC aux head, that head's class list as ``phoneme_list`` so
        that ``partial()`` works."""
        params = trainer.full_params(use_ema)
        manifests = trainer.target_subject.data_manifests
        config = trainer.net_config
        if "phoneme_list" not in kwargs:
            ctc = next((h for h in config.aux_heads if h.distribution == "CTC"), None)
            if ctc is not None and ctc.name in manifests:
                kwargs["phoneme_list"] = manifests[ctc.name].feature_list
        kwargs.setdefault("device", trainer.device)
        return cls(
            params, config, manifests["decoder_targets"].feature_list,
            subject_idx=len(trainer.ecog_subjects) - 1, **kwargs,
        )

    def _upload(self, key: str, array: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        staging = self._staging.get(key)
        if staging is None or tuple(staging.buffer.shape) != array.shape:
            staging = self._staging[key] = _HostStaging(array.shape, dtype, self.device)
        return staging.upload(array)

    def _convolve(self, raw: np.ndarray) -> torch.Tensor:
        """(B, n·d, C_in) raw f32 block → (B, n, F) conv features (no
        dropout), uploaded through the staging buffers."""
        Cp = self.config.in_channels
        B, T, C = raw.shape
        padded = np.zeros((B, T, Cp), np.float32)
        padded[..., :C] = raw[..., :Cp]
        cd = self.config.compute_dtype
        if self._host_upload == "int8":
            q, scales = _quantize_host_block(padded)
            xs = self._upload("q", q, torch.int8).to(cd) * self._upload(
                "scales", scales, torch.float32
            )[:, None, :].to(cd)  # dequantized as the first device operation
        else:
            xs = self._upload("raw", padded, _host_input_dtype(self.config))
        out = convolve_sequences(self.params, self.config, xs.transpose(0, 1), self.subject_idx)
        return out.transpose(0, 1)

    def _require_ctc(self) -> None:
        if self._ctc_head is None:
            raise ValueError("partial() needs a CTC-distribution aux head in the config")

    @property
    def _blank(self) -> int:
        return self.params["aux"][self._ctc_head]["out"]["b"].shape[-1] - 1

    def _ctc_block(self, block: torch.Tensor, want_logp: bool):
        return _ctc_head_apply(self.params, self.config, self._ctc_head, block, want_logp)


class StreamingConformerSession(_ConformerServing):
    """Incremental raw-ECoG → text session for conformer models.

    ``push(chunk)`` takes raw samples (T, C) or (B, T, C) as they arrive;
    each whole chunk of ``samples_per_chunk`` samples is convolved and
    pushed through :class:`models.conformer.ConformerStream` (under
    ``config.conformer.attention_impl``), so encoder outputs accumulate as
    the recording plays.  ``decode()`` flushes the remainder (zero-padded
    to the chunk, the tail steps masked, as the offline padded encode) and
    decodes; it is side-effect free.  ``endpoint()`` decodes and resets:
    the SAME hypothesis as the offline ``greedy_decode`` of the padded
    utterance."""

    def __init__(
        self,
        params,
        config: Seq2SeqConfig,
        targets_list: Sequence[str],
        subject_idx: int = 0,
        phoneme_list: Sequence[str] | None = None,
        quantize: str | None = None,
        host_upload: str | None = None,
        device="cuda",
    ):
        """``phoneme_list``: the class list of a CTC aux head, for
        :meth:`partial`.  ``host_upload='int8'`` quantizes each raw block
        on the host (per-row-per-channel scales, dequantized as the first
        device operation): LOSSY, so the contract becomes streamed ==
        offline on the same int8-dequantized inputs.  ``quantize='int8'``
        rewrites the conformer encoder's weights to per-channel int8 with
        dynamic per-token activation scales (``quantize.py``): the session
        then equals the offline decode with the same quantized weights."""
        super().__init__(params, config, targets_list, subject_idx, phoneme_list,
                         quantize, host_upload, device, "StreamingConformerSession")
        self.stream = ConformerStream(
            self.params["encoder"]["conformer"], self.ccfg, compute_dtype=config.compute_dtype,
        )
        self.reset()

    def reset(self) -> None:
        self.stream.reset()
        self._raw: list[np.ndarray] = []  # pending raw samples
        self._raw_samples = 0
        self._enc_outs: list = []  # (B, chunk, D) emitted blocks
        self._enc_steps = 0  # valid encoder steps emitted
        self._ctc_paths: list = []  # per-block argmax paths (partial())
        self._ctc_logps: list = []  # per-block log-probs (lexicon path)
        # (id(lexicon), beam_width) → {'pos': steps consumed, 'states':
        # one CTCWordBeamState a batch row}, carried across partial() calls
        self._ctc_beams: dict = {}

    @property
    def num_samples(self) -> int:
        return self._enc_steps * self.config.decimation_factor + self._raw_samples

    def push(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim == 2:
            chunk = chunk[None]
        self._raw.append(chunk)
        self._raw_samples += chunk.shape[1]
        spc = self.samples_per_chunk
        with torch.inference_mode():
            while self._raw_samples >= spc:
                raw = np.concatenate(self._raw, axis=1)
                rest = raw[:, spc:]
                self._raw = [rest] if rest.shape[1] else []
                self._raw_samples = rest.shape[1]
                self._enc_outs.append(self.stream.push(self._convolve(raw[:, :spc])))
                self._enc_steps += self.ccfg.chunk_size

    def decode(self) -> dict:
        """Flush the remainder and decode the utterance so far."""
        enc_outs = list(self._enc_outs)
        valid_steps = self._enc_steps
        with torch.inference_mode():
            if self._raw_samples:
                raw = np.concatenate(self._raw, axis=1)
                B, L = raw.shape[:2]
                n_steps = -(-L // self.config.decimation_factor)  # as enc_lengths
                padded = np.zeros((B, self.samples_per_chunk, raw.shape[2]), np.float32)
                padded[:, :L] = raw
                feats = self._convolve(padded)
                # speculative flush: the padded partial chunk must not leak
                # into the live stream, so decode() repeats and push() can
                # go on afterwards
                state = self.stream.snapshot()
                out = self.stream.push(feats, num_valid=n_steps)
                self.stream.restore(state)
                enc_outs.append(out[:, :n_steps])
                valid_steps += n_steps
            if not enc_outs:
                return {"sequences": [""], "tokens": None, "encoder_outputs": None}
            return _decode_pooled_encoder(
                self.params, self.config, self.targets_list, torch.cat(enc_outs, dim=1),
                valid_steps,
            )

    def partial(self, lexicon=None, beam_width: int = 8) -> dict:
        """Live hypothesis from the CTC aux head over the encoder steps
        emitted so far: no decoder pass, no stream mutation.  The head runs
        only on blocks new since the last call.  Greedy best path by
        default; with a :class:`models.ctc.LexiconTrie` also the words of
        the lexicon-constrained beam search, whose state is carried across
        calls (each call advances it over the new steps only, and equals
        the from-scratch search on the whole history).  Returns
        {'phonemes': [[str]] (int ids without a phoneme list), 'words':
        [[str]] | None, 'num_steps': n}."""
        self._require_ctc()
        if not self._enc_outs:
            return {"phonemes": [[]], "words": None, "num_steps": 0}
        with torch.inference_mode():
            for block in self._enc_outs[len(self._ctc_paths):]:
                self._ctc_paths.append(self._ctc_block(block, want_logp=False)[0])
            if lexicon is not None:
                # log-probs are cached lazily: only the lexicon path pays
                # for their copy to the host
                for block in self._enc_outs[len(self._ctc_logps):]:
                    self._ctc_logps.append(self._ctc_block(block, want_logp=True)[1])
        path = np.concatenate(self._ctc_paths, axis=0)[: self._enc_steps]
        B = path.shape[1]
        out: dict = {
            "num_steps": self._enc_steps,
            "words": None,
            "phonemes": [_ctc_phonemes(path[:, b], self._blank, self.phoneme_list)
                         for b in range(B)],
        }
        if lexicon is not None:
            logp = np.concatenate(self._ctc_logps, axis=0)[: self._enc_steps]
            entry = self._ctc_beams.setdefault((id(lexicon), beam_width), {
                "pos": 0,
                "states": [CTCWordBeamState(lexicon, beam_width=beam_width) for _ in range(B)],
            })
            if self._enc_steps > entry["pos"]:
                for b, state in enumerate(entry["states"]):
                    state.advance(logp[entry["pos"]: self._enc_steps, b])
                entry["pos"] = self._enc_steps
            out["words"] = [state.best() for state in entry["states"]]
        return out

    def endpoint(self) -> dict:
        out = self.decode()
        self.reset()
        return out


class RawVoltageSession:
    """Raw-voltage streaming: a :class:`features.StreamingHighGamma` front
    end (notch → high-gamma band bank → Hilbert amplitude → anti-aliased
    decimation) feeding a :class:`StreamingConformerSession`.  Push
    digitizer chunks (int16 or float volts, any length) and decode text.

    The front end keeps its buffers on the host and featurizes each window
    on the session's device.  ``stats``: per-channel (mean, std) from
    :func:`features.calibrate_high_gamma` (per-trial z-scoring does not
    exist mid-stream: serving uses session statistics, as
    ``hg_zscore='block'`` in :class:`datagen.ArrayDataGenerator`).

    ``endpoint()`` equals the offline decode of
    ``(features.extract_high_gamma_np(raw, cfg) - mean) / std`` of the
    whole recording.  ``decode()`` is a side-effect-free peek: it flushes
    the front end's pending tail speculatively through a snapshot and
    restore of the session, so pushes can go on afterwards."""

    def __init__(
        self,
        session: StreamingConformerSession,
        hg_cfg,
        stats=None,
        window_seconds: float = 2.0,
        num_channels: int | None = None,
    ):
        self.session = session
        self.frontend = StreamingHighGamma(
            hg_cfg, int(num_channels or session.config.in_channels),
            window_seconds=window_seconds, stats=stats, device=session.device,
        )

    @classmethod
    def from_trainer(cls, trainer, hg_cfg, stats=None, **kwargs):
        session_kwargs = {
            k: kwargs.pop(k)
            for k in ("use_ema", "quantize", "host_upload", "phoneme_list", "device")
            if k in kwargs
        }
        return cls(StreamingConformerSession.from_trainer(trainer, **session_kwargs),
                   hg_cfg, stats=stats, **kwargs)

    def push(self, raw_chunk: np.ndarray) -> None:
        feats = self.frontend.push(raw_chunk)
        if len(feats):
            self.session.push(feats)

    def partial(self, *args, **kwargs) -> dict:
        """Live CTC-head hypothesis over the frames emitted so far (the
        front end lags the amplifier by its margin, ``pad_seconds`` of
        signal: the notch filter's impulse response)."""
        return self.session.partial(*args, **kwargs)

    def decode(self) -> dict:
        tail = self.frontend.flush(reset=False)
        if not len(tail):
            return self.session.decode()
        s = self.session
        state = s.stream.snapshot()
        saved = (list(s._raw), s._raw_samples, list(s._enc_outs), s._enc_steps)
        try:
            s.push(tail)
            return s.decode()
        finally:
            s.stream.restore(state)
            s._raw, s._raw_samples, s._enc_outs, s._enc_steps = (
                list(saved[0]), saved[1], list(saved[2]), saved[3])

    def endpoint(self) -> dict:
        tail = self.frontend.flush()
        if len(tail):
            self.session.push(tail)
        return self.session.endpoint()

    def reset(self) -> None:
        self.frontend.flush()
        self.session.reset()


class StreamingSessionPool(_ConformerServing):
    """Batched multi-tenant streaming: up to ``capacity`` concurrent
    raw-ECoG streams through one batched device step a tick.

    Each slot is an independent stream with its own absolute clock
    (streams join and leave at any time), yet every tick runs one batched
    conv and one batched window encode over all slots: per-row position
    offsets and valid lengths carry each stream's coordinates through the
    shared computation (``conformer_encode`` with a (B,) offset).  The
    window's attention is pinned to the plain 'dense' (up to 256 steps) or
    'banded' path, as the JAX package pins them for its ``vmap``: the
    kernels take one offset for the batch.  Its LayerNorms run K5f on the
    card.

    Per slot the semantics are EXACTLY :class:`StreamingConformerSession`
    with B=1 (the same window, left fill and partial-chunk flush)."""

    def __init__(
        self,
        params,
        config: Seq2SeqConfig,
        targets_list: Sequence[str],
        capacity: int = 8,
        subject_idx: int = 0,
        max_pending_chunks: int = 2,
        phoneme_list: Sequence[str] | None = None,
        quantize: str | None = None,
        host_upload: str | None = None,
        device="cuda",
    ):
        """``max_pending_chunks``: a tick normally waits until every active
        slot has a full chunk buffered (one batched step serves all
        streams); if a straggler idles while another slot holds this many
        chunks, the pool ticks the ready slots anyway.  ``host_upload`` and
        ``quantize``: see :class:`StreamingConformerSession`."""
        super().__init__(params, config, targets_list, subject_idx, phoneme_list,
                         quantize, host_upload, device, "StreamingSessionPool")
        self.capacity = int(capacity)
        self.window_steps = receptive_field_steps(self.ccfg) + self.ccfg.chunk_size
        impl = "dense" if self.window_steps <= _AUTO_DENSE_MAX_STEPS else "banded"
        self._encode_cfg = dataclasses.replace(self.ccfg, attention_impl=impl)
        self.max_pending_chunks = int(max_pending_chunks)
        self._slots: list[dict | None] = [None] * self.capacity
        self._windows = None  # (N, W, F) on the device, made at the first tick

    # -- slot management ------------------------------------------------
    def add(self) -> int:
        """Claim a free slot for a new stream; returns the slot id."""
        for i, s in enumerate(self._slots):
            if s is None:
                self._slots[i] = {
                    "raw": [], "raw_samples": 0, "pushed": 0, "valid": 0, "steps": 0,
                    "enc": [],  # this stream's own (C, D) blocks
                    "ctc_paths": [], "ctc_logps": [], "ctc_beams": {},
                }
                # a reused slot must not see its previous occupant's window
                if self._windows is not None:
                    with torch.inference_mode():
                        self._windows[i].zero_()
                return i
        raise RuntimeError(f"pool is full (capacity {self.capacity})")

    def release(self, slot: int) -> None:
        self._slots[slot] = None  # its state (encoder blocks too) goes with it

    def _slot(self, slot: int) -> dict:
        s = self._slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is not active")
        return s

    # -- device step ----------------------------------------------------
    def _tick(self, ready: dict[int, np.ndarray], commit: bool = True) -> torch.Tensor:
        """One batched device step over ``ready`` {slot: (spc, C_in) raw
        block}; returns the (N, C, D) encoder block."""
        Cp = self.config.in_channels
        raws = np.zeros((self.capacity, self.samples_per_chunk, Cp), np.float32)
        for i, blk in ready.items():
            raws[i, :, : blk.shape[1]] = blk[:, :Cp]
        feats = self._convolve(raws)  # (N, C, F), one staging buffer
        if self._windows is None:
            self._windows = torch.zeros(
                (self.capacity, self.window_steps, feats.shape[-1]), dtype=feats.dtype,
                device=self.device,
            )
        C = self.ccfg.chunk_size
        lengths = np.zeros((self.capacity,), np.int32)
        offsets = np.zeros((self.capacity,), np.int64)
        active = np.zeros((self.capacity,), bool)
        for i in ready:
            s = self._slots[i]
            lengths[i] = s["_tick_valid"]
            offsets[i] = s["pushed"] + C - self.window_steps
            active[i] = True
        to_dev = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        windows = torch.cat([self._windows[:, C:], feats], dim=1)
        out, _ = conformer_encode(
            self.params["encoder"]["conformer"], self._encode_cfg, windows, to_dev(lengths),
            position_offset=to_dev(offsets), compute_dtype=self.config.compute_dtype,
            mask_invalid=True,
        )
        if commit:
            self._windows = torch.where(to_dev(active)[:, None, None], windows, self._windows)
        return out[:, -C:]

    def _advance(self, force_slot: int | None = None) -> None:
        """Tick while a batched step is due: when every active slot has a
        full chunk, when a slot is ``max_pending_chunks`` overdue, or when
        ``force_slot`` needs draining (decode)."""
        spc = self.samples_per_chunk
        C = self.ccfg.chunk_size
        while True:
            active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
            pending = {i: s["raw_samples"] // spc for i, s in active}
            if not pending or not any(pending.values()):
                return
            due = (
                all(pending.values())
                or max(pending.values()) >= self.max_pending_chunks
                or (force_slot is not None and pending.get(force_slot))
            )
            if not due:
                return
            ready = {}
            for i, s in active:
                if s["raw_samples"] >= spc:
                    raw = np.concatenate(s["raw"], axis=0)
                    ready[i] = raw[:spc]
                    rest = raw[spc:]
                    s["raw"] = [rest] if len(rest) else []
                    s["raw_samples"] = len(rest)
                    s["_tick_valid"] = s["valid"] + C  # absolute, after the tick
            outs = self._tick(ready)
            for i in ready:
                s = self._slots[i]
                s["pushed"] += C
                s["valid"] += C
                s["steps"] += C
                s["enc"].append(outs[i])  # its own row only, freed with the slot

    # -- public API -----------------------------------------------------
    def push(self, slot: int, samples: np.ndarray) -> None:
        """Append raw samples (T, C_in) to a stream; ragged sizes are fine."""
        s = self._slot(slot)
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 2:
            raise ValueError("push expects (T, C_in) raw samples")
        s["raw"].append(samples)
        s["raw_samples"] += len(samples)
        with torch.inference_mode():
            self._advance()

    def decode(self, slot: int) -> dict:
        """Flush and decode one stream, side-effect free: the stream keeps
        running (the single session's contract)."""
        s = self._slot(slot)
        with torch.inference_mode():
            # drain this stream's buffered full chunks first (other ready
            # slots ride along in the same ticks)
            self._advance(force_slot=slot)
            enc_rows = list(s["enc"])
            valid_steps = s["steps"]
            if s["raw_samples"]:
                raw = np.concatenate(s["raw"], axis=0)
                n_steps = -(-len(raw) // self.config.decimation_factor)
                padded = np.zeros((self.samples_per_chunk, raw.shape[1]), np.float32)
                padded[: len(raw)] = raw
                s["_tick_valid"] = s["valid"] + n_steps
                out = self._tick({slot: padded}, commit=False)
                enc_rows.append(out[slot, :n_steps])
                valid_steps += n_steps
            if not enc_rows:
                return {"sequences": [""], "tokens": None, "encoder_outputs": None}
            return _decode_pooled_encoder(
                self.params, self.config, self.targets_list, torch.cat(enc_rows)[None],
                valid_steps,
            )

    def partial(self, slot: int, lexicon=None, beam_width: int = 8) -> dict:
        """Live hypothesis for ONE stream from the CTC aux head over its
        encoder steps so far: the pool twin of
        :meth:`StreamingConformerSession.partial` (the same cached blocks
        and carried lexicon beam).  Returns {'phonemes': [ids or labels],
        'words': [str] | None, 'num_steps': n} for this slot."""
        self._require_ctc()
        s = self._slot(slot)
        if not s["enc"]:
            return {"phonemes": [], "words": None, "num_steps": 0}
        with torch.inference_mode():
            for block in s["enc"][len(s["ctc_paths"]):]:
                s["ctc_paths"].append(self._ctc_block(block[None], want_logp=False)[0])
            if lexicon is not None:
                for block in s["enc"][len(s["ctc_logps"]):]:
                    s["ctc_logps"].append(self._ctc_block(block[None], want_logp=True)[1])
        path = np.concatenate(s["ctc_paths"], axis=0)[: s["steps"], 0]
        out: dict = {
            "num_steps": s["steps"],
            "phonemes": _ctc_phonemes(path, self._blank, self.phoneme_list),
            "words": None,
        }
        if lexicon is not None:
            logp = np.concatenate(s["ctc_logps"], axis=0)[: s["steps"]]
            entry = s["ctc_beams"].setdefault((id(lexicon), beam_width), {
                "pos": 0, "state": CTCWordBeamState(lexicon, beam_width=beam_width),
            })
            if s["steps"] > entry["pos"]:
                entry["state"].advance(logp[entry["pos"]: s["steps"], 0])
                entry["pos"] = s["steps"]
            out["words"] = entry["state"].best()
        return out

    def endpoint(self, slot: int) -> dict:
        """Final decode; the slot is released back to the pool."""
        out = self.decode(slot)
        self.release(slot)
        return out
