"""Encoder-decoder seq2seq core, LSTM and conformer families: inference
and training.

The twin of ``ecog2txt_tpu/models/seq2seq.py`` with the same parameter
tree (nested dicts and lists, the same keys and shapes, weights stored
(in, out)) and the same functions at the same layouts:

* per-subject ``subnet``: a temporal conv of width == stride computed as
  a reshape-GEMM, with the reference's input reversal fused in (weight
  rows flipped inside each stride group, output reversed at the
  decimated rate);
* a bidirectional LSTM encoder stack (``ops.lstm``; with
  ``use_pallas_lstm=True`` the recurrences run the Hopper kernels K1f /
  K1b one direction per launch, with ``'bi_grid'`` both directions of a
  layer run in one launch of K4f / K4b), or, with
  ``encoder_type='conformer'``, the chunked-causal conformer
  (``models.conformer``; its ``attention_impl`` picks the Hopper
  attention kernels) over natural-order steps, bridged to the decoder
  by a masked mean over the valid steps;
* an attention-free (or Luong cross-attention) LSTM decoder started from
  the encoder's final state, teacher-forced or greedy / temperature
  sampled;
* training: feed-forward dropout after the conv and between stacked
  layers, variational recurrent dropout (one mask per sequence, layer
  and direction), and :func:`seq2seq_loss` with categorical, CTC
  (``models.ctc``), Gaussian and Rayleigh auxiliary heads beside the
  decoder cross-entropy;
* the parallel modes of ``parallel/``: ``dp`` (each rank a slice of the
  global batch; every mean divides by the global batch's count), ``sp``
  (the conformer's time axis over ranks, ``parallel/sequence.py``), ``ep``
  (the MoE FFN's experts over ranks), each a ``(mesh, axis)`` pair as the
  JAX package's ``sp`` is, ``pp`` (the conformer's block stack over ranks,
  ``parallel/pipeline.py``; with ``sp`` too, ``parallel/sp_pp.py``), a
  ``(mesh, axis, microbatches)``, and ``tp`` (the wide weights' columns
  over ranks), a ``(mesh, axis, mask)``: the leaves ``mask`` marks are
  gathered whole on entry (``parallel.mesh.gather_params_tp``) and every
  rank runs the unsharded function.  ``parallel.mesh.parallel_modes``
  builds these keywords from a mesh.

Sequences are time-major ``(T, B, F)``.  Products round their operands
to ``compute_dtype`` and accumulate in f32 (``ops.lstm.dot_f32``).
Where JAX takes an ``rng`` key the port takes a ``torch.Generator`` on
the device of the tensors; the draws differ from JAX's, their rates and
scaling do not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from .. import resolve_device
from ..convert import tree_map
from ..ops.lstm import (
    bidirectional_lstm,
    check_use_pallas,
    dot_f32,
    init_lstm_params,
    lstm_scan,
    lstm_step,
    reverse_padded,
)
from ..parallel.comm import all_reduce_sum, all_reduce_tree
from ..parallel.mesh import gather_params_tp
from .conformer import ConformerConfig, conformer_encode, init_conformer, moe_aux_from_stats
from .ctc import ctc_loss


class AuxHead(NamedTuple):
    """One auxiliary encoder target head (e.g. 'encoder_1_targets')."""

    name: str
    distribution: str  # 'categorical' | 'CTC' | 'Gaussian' | 'Rayleigh'
    out_dim: int  # num classes or num features


@dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int
    num_subjects: int = 1
    in_channels: int = 256  # common (padded) channel count
    conv_sizes: tuple = (100,)
    decimation_factor: int = 12
    rnn_sizes: tuple = (400, 400, 400)
    aux_proj_sizes: tuple = (225,)
    aux_heads: tuple = ()  # tuple[AuxHead]
    dec_embedding_size: int = 150
    dec_rnn_sizes: tuple = (800,)
    max_dec_len: int = 20
    FF_dropout: float = 0.1
    RNN_dropout: float = 0.5
    temperature: float = 0.0  # 0 → greedy argmax
    BIDIRECTIONAL: bool = True
    # encoder recurrences on the Hopper kernels (ops/lstm_kernels.py):
    # True, one launch per direction (K1f/K1b); 'bi_grid', both
    # directions of a layer in one launch (K4f/K4b).  The field keeps the
    # JAX package's name and values so one manifest drives both packages
    use_pallas_lstm: bool | str = False
    encoder_type: str = "lstm"  # 'lstm' | 'conformer'
    conformer: ConformerConfig | None = None  # used when encoder_type=conformer
    use_attention: bool = False
    compute_dtype: torch.dtype = torch.float32
    pad_id: int = 0
    eos_id: int = 1

    def __post_init__(self):
        if self.encoder_type not in ("lstm", "conformer"):
            raise ValueError(
                f"encoder_type={self.encoder_type!r}: expected 'lstm' or 'conformer'"
            )
        check_use_pallas(self.use_pallas_lstm)
        if not isinstance(self.compute_dtype, torch.dtype):
            raise TypeError(
                f"compute_dtype must be a torch dtype; got {self.compute_dtype!r}"
            )

    @property
    def conv_strides(self) -> tuple:
        """Factor ``decimation_factor`` into one stride per conv layer
        (near-equal factors)."""
        if not self.conv_sizes:
            return ()
        remaining = self.decimation_factor
        n = len(self.conv_sizes)
        strides = []
        for i in range(n, 0, -1):
            s = max(int(round(remaining ** (1.0 / i))), 1)
            while remaining % s and s > 1:
                s -= 1
            strides.append(s)
            remaining //= s
        strides[-1] *= remaining  # absorb any leftover
        return tuple(strides)

    @property
    def enc_out_dim(self) -> int:
        if self.encoder_type == "conformer":
            return (self.conformer or ConformerConfig()).model_dim
        return self.rnn_sizes[-1] * (2 if self.BIDIRECTIONAL else 1)


def _dense_init(generator, in_dim, out_dim):
    scale = (6.0 / (in_dim + out_dim)) ** 0.5
    w = (torch.rand((in_dim, out_dim), generator=generator) * 2 - 1) * scale
    return {"w": w, "b": torch.zeros(out_dim)}


def _dense(params, x, compute_dtype=torch.float32):
    return dot_f32(x, params["w"], compute_dtype) + params["b"]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_seq2seq(
    config: Seq2SeqConfig,
    generator: torch.Generator | None = None,
    device="cuda",
) -> dict:
    """Parameter tree (subnet parameters carry a leading subject axis),
    drawn from the CPU ``generator`` (seed 0 when None) and placed on
    ``device``."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params: dict[str, Any] = {}

    # per-subject conv stack, stacked on axis 0
    subnet_layers = []
    in_dim = config.in_channels
    for size, stride in zip(config.conv_sizes, config.conv_strides):
        per_subject = [
            _dense_init(g, in_dim * stride, size)
            for _ in range(config.num_subjects)
        ]
        subnet_layers.append(
            {k: torch.stack([p[k] for p in per_subject]) for k in ("w", "b")}
        )
        in_dim = size
    params["subnet"] = {"conv": subnet_layers}

    if config.encoder_type == "conformer":
        ccfg = config.conformer or ConformerConfig()
        params["encoder"] = {
            "conformer": init_conformer(g, ccfg, in_dim, device="cpu")
        }
    else:
        enc_layers = []
        for size in config.rnn_sizes:
            if config.BIDIRECTIONAL:
                enc_layers.append(
                    {
                        "fwd": init_lstm_params(g, in_dim, size, device="cpu"),
                        "bwd": init_lstm_params(g, in_dim, size, device="cpu"),
                    }
                )
                in_dim = 2 * size
            else:
                enc_layers.append(
                    {"fwd": init_lstm_params(g, in_dim, size, device="cpu")}
                )
                in_dim = size
        params["encoder"] = {"rnn": enc_layers}

    # aux heads: MLP (aux_proj_sizes) → linear to target dim
    aux = {}
    for head in config.aux_heads:
        hidden = []
        dim = config.enc_out_dim
        for size in config.aux_proj_sizes:
            hidden.append(_dense_init(g, dim, size))
            dim = size
        aux[head.name] = {"mlp": hidden, "out": _dense_init(g, dim, head.out_dim)}
    params["aux"] = aux

    decoder: dict[str, Any] = {
        "embedding": torch.randn(
            (config.vocab_size, config.dec_embedding_size), generator=g
        ) / config.dec_embedding_size ** 0.5,
    }
    dec_layers = []
    in_dim = config.dec_embedding_size
    for size in config.dec_rnn_sizes:
        dec_layers.append(init_lstm_params(g, in_dim, size, device="cpu"))
        in_dim = size
    decoder["rnn"] = dec_layers
    # bridge from encoder final state to decoder layer-0 state when the
    # sizes differ (they match in the reference config: 2×400 = 800)
    if config.enc_out_dim != config.dec_rnn_sizes[0]:
        decoder["bridge_h"] = _dense_init(g, config.enc_out_dim, config.dec_rnn_sizes[0])
        decoder["bridge_c"] = _dense_init(g, config.enc_out_dim, config.dec_rnn_sizes[0])
    if config.use_attention:
        decoder["attn"] = {
            "wa": _dense_init(g, in_dim, config.enc_out_dim),
            "wc": _dense_init(g, in_dim + config.enc_out_dim, in_dim),
        }
    decoder["out"] = _dense_init(g, in_dim, config.vocab_size)
    params["decoder"] = decoder
    return tree_map(lambda a: a.to(dev), params)


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------


def _require_generator(generator, train: bool) -> None:
    """Dropout draws from an explicit generator, as JAX's ``rng`` is
    required: ``train`` without one is an error, not a fixed seed."""
    if train and generator is None:
        raise ValueError("train=True needs a torch.Generator for dropout")


def _ff_dropout(generator, x, rate, train):
    """Inverted dropout: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _recurrent_mask(generator, B, H, rate, device) -> torch.Tensor:
    """Variational recurrent dropout: one (B, H) f32 mask of 0 and
    ``1 / (1 - rate)`` applied to ``h`` at every step."""
    keep = 1.0 - rate
    draw = torch.rand((B, H), generator=generator, device=device)
    return (draw < keep).float() / keep


def _select_subject(stacked, subject_idx):
    return tree_map(lambda a: a[subject_idx], stacked)


def convolve_sequences(
    params: dict,
    config: Seq2SeqConfig,
    xs: torch.Tensor,  # (T, B, C) time-major
    subject_idx,
    generator: torch.Generator | None = None,
    train: bool = False,
    reverse_lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-subject temporal conv stack (width == stride, 'VALID') as a
    reshape-GEMM: (T, B, C) → (B, T/d, d·C) @ W_subject → relu →
    dropout (``train``).

    With ``reverse_lengths``, ``xs`` is unreversed and the input
    reversal is fused into the first layer: convolving the reversed
    input equals convolving the raw input with the weight rows flipped
    within each stride group and reversing the output at the decimated
    rate (exactly, when valid lengths are stride multiples).  The input
    is cast to ``compute_dtype`` first; no ``conv1d`` (cuDNN would run
    an f32 conv in TF32)."""
    for i, (layer, stride) in enumerate(
        zip(params["subnet"]["conv"], config.conv_strides)
    ):
        w = _select_subject(layer, subject_idx)
        T, B, C = xs.shape
        F_out = w["w"].shape[-1]
        wg = w["w"].reshape(stride, C, F_out)
        if reverse_lengths is not None and i == 0:
            wg = wg.flip(0)
        T_out = T // stride
        # batch-major (B, T'·stride, C) → (B, T', stride·C) is a view
        # when the batch-major input is contiguous (encode's inputs are)
        xb = xs.transpose(0, 1)[:, : T_out * stride].to(config.compute_dtype)
        out = dot_f32(
            xb.reshape(B, T_out, stride * C),
            wg.reshape(stride * C, F_out),
            config.compute_dtype,
        )  # (B, T', F) f32
        xs = torch.relu(out + w["b"]).transpose(0, 1)
        if reverse_lengths is not None and i == 0:
            lens0 = torch.clamp(
                (reverse_lengths + stride - 1) // stride, max=T_out
            )
            xs = reverse_padded(xs, lens0)
        xs = _ff_dropout(generator, xs, config.FF_dropout, train)
    return xs


def _whole(params: dict, tp: tuple | None) -> dict:
    """``params`` with the column-split leaves of ``tp=(mesh, axis, mask)``
    gathered whole (itself without ``tp``)."""
    return params if tp is None else gather_params_tp(params, tp[0], tp[2], tp[1])


def encode(
    params: dict,
    config: Seq2SeqConfig,
    inputs: torch.Tensor,  # (B, T, C) batch-major raw
    lengths: torch.Tensor,  # (B,)
    subject_idx,
    generator: torch.Generator | None = None,
    train: bool = False,
    return_aux: bool = False,
    sp: tuple | None = None,
    ep: tuple | None = None,
    dp: tuple | None = None,
    pp: tuple | None = None,
    tp: tuple | None = None,
):
    """Full encoder: reversal → conv → biLSTM stack, or (conformer
    family) conv → conformer in natural time order, with dropout when
    ``train`` (drawn from ``generator``, which ``train`` requires).

    Returns (enc_outputs (T', B, E), final (h, c) (B, E), enc_lengths
    (B,)); for the conformer, the outputs are zero past each length and
    the final state is their masked mean over the valid steps.
    ``return_aux`` appends the MoE conformer's weighted router aux loss
    (0 for every other configuration).

    ``sp=(mesh, axis)`` shards the conformer encode's time axis over
    ``mesh``'s ``axis`` (``parallel/sequence.py``; differentiable): the
    subsample conv runs on every rank, the steps are padded to a multiple
    of the axis's ranks times the chunk, and the output is gathered over
    time for the decoder.  ``ep=(mesh, ep_axis)`` runs the MoE FFN with its
    experts over ``ep_axis``.
    ``dp=(mesh, axis)``: this batch is the rank's slice of the global
    batch over ``axis``, and the router statistics are summed over it
    before the aux loss (the biLSTM encodes its slice as it is).
    ``pp=(mesh, axis, microbatches)`` pipelines the conformer's blocks over
    ``axis`` (``parallel/pipeline.py``; with ``sp`` on the same mesh,
    ``parallel/sp_pp.py``).  ``tp=(mesh, axis, mask)``: the leaves of
    ``params`` that ``mask`` marks hold this rank's columns, and are
    gathered over ``axis`` first."""
    if sp is not None and config.encoder_type != "conformer":
        raise ValueError(
            "sequence parallelism requires encoder_type='conformer' "
            "(the biLSTM recurrence cannot shard over time)"
        )
    if pp is not None and config.encoder_type != "conformer":
        raise ValueError("pipeline parallelism requires encoder_type='conformer'")
    _require_generator(generator, train)
    params = _whole(params, tp)
    xs = inputs.transpose(0, 1)  # (T, B, C)
    # the LSTM family reads its input reversed (fused into the first
    # conv layer); the chunked-causal conformer reads natural order so
    # the same function streams chunk by chunk
    reverse = config.encoder_type != "conformer"
    if config.conv_sizes:
        xs = convolve_sequences(
            params, config, xs, subject_idx, generator, train,
            reverse_lengths=lengths if reverse else None,
        )
    else:
        # no-conv experiment variant: plain strided decimation
        if reverse:
            xs = reverse_padded(xs, lengths)
        d0 = config.decimation_factor
        xs = xs[: (xs.shape[0] // d0) * d0 : d0]
    d = config.decimation_factor
    enc_lengths = torch.clamp((lengths + d - 1) // d, max=xs.shape[0])

    if config.encoder_type == "conformer":
        ccfg = config.conformer or ConformerConfig()
        xs_bm = xs.transpose(0, 1)  # (B, T', F)
        ep_axis = ep[1] if ep is not None else None
        data_axes = (dp[1],) if dp is not None else ()
        conformer = params["encoder"]["conformer"]
        if sp is not None and pp is not None:
            from ..parallel.sequence import pad_to_shards
            from ..parallel.sp_pp import sp_pp_conformer_encode

            mesh, axis = sp[0], sp[1]
            out_bm, moe_aux = sp_pp_conformer_encode(
                conformer, ccfg, pad_to_shards(xs_bm, mesh, axis, ccfg.chunk_size), mesh,
                axis, pp[1], pp[2], enc_lengths, config.compute_dtype, return_aux=True,
                ep_axis=ep_axis,
            )
            out_bm = out_bm[:, :xs_bm.shape[1]]
        elif sp is not None:
            from ..parallel.sequence import pad_to_shards, sequence_parallel_encode

            mesh, axis = sp[0], sp[1]
            out_bm, moe_aux = sequence_parallel_encode(
                conformer, ccfg,
                pad_to_shards(xs_bm, mesh, axis, ccfg.chunk_size), mesh, axis,
                enc_lengths, config.compute_dtype, return_aux=True, ep_axis=ep_axis,
                stats_axes=(axis, *data_axes),
            )
            out_bm = out_bm[:, :xs_bm.shape[1]]
        elif pp is not None:
            from ..parallel.pipeline import pipeline_conformer_encode

            out_bm, moe_aux = pipeline_conformer_encode(
                conformer, ccfg, xs_bm, pp[0], pp[1], pp[2], enc_lengths,
                config.compute_dtype, return_aux=True, ep_axis=ep_axis,
            )
        else:
            mesh = (ep or dp or (None,))[0]
            out_bm, _, stats = conformer_encode(
                conformer, ccfg, xs_bm, enc_lengths,
                compute_dtype=config.compute_dtype, return_moe_stats=True,
                ep_axis=mesh.group(ep_axis) if ep_axis is not None else None,
            )  # (B, T', D)
            if data_axes:
                stats = all_reduce_tree(stats, mesh.group(*data_axes))
            moe_aux = moe_aux_from_stats(ccfg, stats, out_bm.device)
        T_out = out_bm.shape[1]
        step_mask = (
            torch.arange(T_out, device=out_bm.device)[None, :] < enc_lengths[:, None]
        )[..., None]
        denom = torch.clamp(enc_lengths[:, None], min=1).to(out_bm.dtype)
        pooled = (out_bm * step_mask).sum(dim=1) / denom
        out = (out_bm * step_mask).transpose(0, 1)  # (T', B, D)
        if return_aux:
            return out, (pooled, pooled), enc_lengths, moe_aux
        return out, (pooled, pooled), enc_lengths

    out = xs
    final_h = final_c = None
    layers = params["encoder"]["rnn"]
    recurrent_dropout = train and config.RNN_dropout > 0
    for i, layer in enumerate(layers):
        B, H = out.shape[1], layer["fwd"]["wh"].shape[0]
        if config.BIDIRECTIONAL:
            masks = None
            if recurrent_dropout:
                masks = tuple(
                    _recurrent_mask(generator, B, H, config.RNN_dropout, out.device)
                    for _ in "fb"
                )
            out, (final_h, final_c) = bidirectional_lstm(
                layer["fwd"], layer["bwd"], out, enc_lengths, masks,
                config.compute_dtype, use_pallas=config.use_pallas_lstm,
            )
        else:
            mask = None
            if recurrent_dropout:
                mask = _recurrent_mask(
                    generator, B, H, config.RNN_dropout, out.device
                )
            out, (final_h, final_c) = lstm_scan(
                layer["fwd"], out, enc_lengths, None, mask,
                config.compute_dtype, use_pallas=config.use_pallas_lstm,
            )
        if i < len(layers) - 1:
            out = _ff_dropout(generator, out, config.FF_dropout, train)
    if return_aux:
        return out, (final_h, final_c), enc_lengths, torch.zeros((), device=out.device)
    return out, (final_h, final_c), enc_lengths


def _decoder_init_state(params: dict, config: Seq2SeqConfig, enc_final):
    h, c = enc_final
    decoder = params["decoder"]
    if "bridge_h" in decoder:
        h = torch.tanh(_dense(decoder["bridge_h"], h, config.compute_dtype))
        c = torch.tanh(_dense(decoder["bridge_c"], c, config.compute_dtype))
    states = [(h, c)]
    B = h.shape[0]
    for size_params in decoder["rnn"][1:]:
        H = size_params["wh"].shape[0]
        zeros = torch.zeros((B, H), dtype=torch.float32, device=h.device)
        states.append((zeros, zeros))
    return states


def _attend(
    attn_params,
    h_dec: torch.Tensor,  # (..., B, H_dec) decoder states
    enc_out: torch.Tensor,  # (T', B, E)
    enc_lengths: torch.Tensor,  # (B,)
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Luong general attention + combine: softmax((h Wa) · enc) over
    valid encoder steps → tanh(Wc [h; context])."""
    enc = enc_out.float()
    query = _dense(attn_params["wa"], h_dec, compute_dtype)  # (..., B, E)
    scores = torch.einsum("...be,tbe->...bt", query, enc)
    valid = (
        torch.arange(enc.shape[0], device=enc.device)[None, :]
        < enc_lengths[:, None]
    )  # (B, T')
    scores = torch.where(valid, scores, -1e9)
    weights = torch.softmax(scores, dim=-1)
    context = torch.einsum("...bt,tbe->...be", weights, enc)
    combined = torch.cat([h_dec, context], dim=-1)
    return torch.tanh(_dense(attn_params["wc"], combined, compute_dtype))


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------


def decoder_teacher_forcing(
    params: dict,
    config: Seq2SeqConfig,
    enc_final,
    targets: torch.Tensor,  # (B, L) EOS-terminated, pad-padded
    generator: torch.Generator | None = None,
    train: bool = False,
    enc_out: torch.Tensor | None = None,  # (T', B, E) for attention
    enc_lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Teacher-forced logits (L, B, V).  Decoder inputs are the targets
    shifted right behind an initial ``<pad>``; with ``train``, recurrent
    and between-layer dropout are drawn from ``generator``."""
    _require_generator(generator, train)
    decoder = params["decoder"]
    targets = targets.long()
    shifted = torch.cat(
        [torch.full_like(targets[:, :1], config.pad_id), targets[:, :-1]],
        dim=1,
    )
    out = decoder["embedding"][shifted].transpose(0, 1)  # (L, B, E)
    states = _decoder_init_state(params, config, enc_final)
    B = targets.shape[0]
    for li, layer in enumerate(decoder["rnn"]):
        mask = None
        if train and config.RNN_dropout > 0:
            mask = _recurrent_mask(
                generator, B, layer["wh"].shape[0], config.RNN_dropout,
                out.device,
            )
        # decoder sequences are short and wide: the step loop, not the
        # kernel (as in the JAX package)
        out, _ = lstm_scan(layer, out, None, states[li], mask, config.compute_dtype)
        if li < len(decoder["rnn"]) - 1:
            out = _ff_dropout(generator, out, config.FF_dropout, train)
    if config.use_attention:
        out = _attend(
            decoder["attn"], out, enc_out, enc_lengths, config.compute_dtype
        )
    return _dense(decoder["out"], out, config.compute_dtype)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _decimate_targets(ts, lengths, stride: int, T_out: int, reverse: bool = True):
    """Align per-sample encoder targets (T, B, ...) with encoder steps:
    reverse the valid prefix (matching the encoder's input reversal),
    then take every ``stride``-th sample.  ``reverse=False`` for the
    natural-order (conformer) encoder."""
    if reverse:
        ts = reverse_padded(ts, lengths)
    return ts[: T_out * stride : stride]


def rayleigh_nll(log_sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise Rayleigh negative log-likelihood, log-σ head:
    ``2·log σ + x²/(2σ²) − log x`` with x clamped at 1e-6 (padded zeros
    stay finite; they are masked out of the loss anyway)."""
    x = torch.clamp(x, min=1e-6)
    return 2.0 * log_sigma + 0.5 * x * x * torch.exp(-2.0 * log_sigma) - torch.log(x)


def _masked_mean(values, mask, count=None):
    """Sum of ``values`` over ``mask`` divided by max(count, 1); ``count``
    defaults to the mask's own (a data-parallel rank passes the global
    batch's)."""
    m = mask.to(values.dtype)
    count = m.sum() if count is None else count.to(values.dtype)
    return (values * m).sum() / torch.clamp(count, min=1.0)


class _Shares:
    """How a rank's loss terms add up to the global loss on a mesh.

    Each rank returns its share: the shares summed over every rank of the
    mesh are the loss over the global batch, so the gradients summed over
    the ranks that hold a leaf are its single-device gradient (the
    collectives' adjoints do the rest, ``parallel/comm.py``).  A mean over
    tokens divides the rank's sum by the global batch's count (summed over
    the ``dp`` axis) and by the ranks that see the same slice of the batch
    (the other axes: under sp, ep, tp and pp every rank of a line computes
    the same decoder loss); the MoE aux loss, the same on every rank, by
    the mesh's size.  Without a mesh every factor is 1."""

    def __init__(self, sp, ep, dp, pp=None, tp=None):
        self.mesh = next((p[0] for p in (sp, ep, dp, pp, tp) if p is not None), None)
        self.dp = dp
        if self.mesh is None:
            self.replicas = self.size = 1
        else:
            self.size = self.mesh.size
            self.replicas = self.size // (self.mesh.shape[dp[1]] if dp is not None else 1)

    def counts(self, *counts: torch.Tensor) -> list[torch.Tensor]:
        """The global batch's token counts (no gradient)."""
        if self.dp is None:
            return list(counts)
        with torch.no_grad():
            total = all_reduce_sum(torch.stack([c.float() for c in counts]),
                                   self.mesh.group(self.dp[1]))
        return list(total.unbind())

    def metrics(self, shares: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The global values of the metrics from every rank's shares."""
        if self.mesh is None:
            return shares
        names = list(shares)
        with torch.no_grad():
            total = all_reduce_sum(torch.stack([shares[k].detach().float() for k in names]),
                                   self.mesh.group(*self.mesh.axis_names))
        return dict(zip(names, total.unbind()))


def seq2seq_loss(
    params: dict,
    config: Seq2SeqConfig,
    batch: dict[str, torch.Tensor],
    generator: torch.Generator | None = None,
    train: bool = True,
    penalty_scales: dict[str, float] | None = None,
    sp: tuple | None = None,
    ep: tuple | None = None,
    dp: tuple | None = None,
    pp: tuple | None = None,
    tp: tuple | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss + metrics.

    ``batch``: 'encoder_inputs' (B,T,C), 'encoder_lengths' (B,),
    'decoder_targets' (B,L) EOS-terminated, 'decoder_lengths' (B,),
    'subject_idx' scalar int, plus one entry per aux head (per-sample
    targets at the raw rate: categorical (B,T), Gaussian/Rayleigh
    (B,T,F); CTC: label sequences (B,N) beside '<name>_lengths' (B,)).  ``penalty_scales``: loss weight per aux head name and for
    'decoder_targets'.  Metrics: ``loss_<head>``, ``loss_decoder``,
    ``token_accuracy``, ``loss_total``, and ``moe_aux`` for the MoE
    conformer (its weighted router loss, part of the total).

    ``sp``, ``ep``, ``dp``, ``pp``, ``tp``: the parallel modes of
    :func:`encode`, on one mesh (under ``tp`` the whole tree is gathered
    first).  Then the returned loss is this rank's share of the
    global loss (the shares of every rank of the mesh sum to it:
    ``_Shares``), and the metrics are the global values, summed over the
    mesh.
    """
    penalty_scales = penalty_scales or {}
    _require_generator(generator, train)
    shares = _Shares(sp, ep, dp, pp, tp)
    params = _whole(params, tp)
    enc_out, enc_final, enc_lengths, moe_aux = encode(
        params, config, batch["encoder_inputs"], batch["encoder_lengths"],
        batch["subject_idx"], generator, train, return_aux=True, sp=sp, ep=ep, dp=dp,
        pp=pp,
    )
    T_out = enc_out.shape[0]
    step_mask = (
        torch.arange(T_out, device=enc_out.device)[:, None] < enc_lengths[None, :]
    )  # (T', B)
    targets = batch["decoder_targets"]  # (B, L)
    L = targets.shape[1]
    dec_mask = (
        torch.arange(L, device=enc_out.device)[:, None]
        < batch["decoder_lengths"].to(enc_out.device)[None, :]
    )  # (L, B)
    ctc_heads = [h for h in config.aux_heads if h.distribution == "CTC"]
    step_count, dec_count, *ctc_counts = shares.counts(
        step_mask.sum(), dec_mask.sum(),
        *(batch[f"{h.name}_lengths"].to(enc_out.device).sum() for h in ctc_heads),
    )
    ctc_counts = dict(zip((h.name for h in ctc_heads), ctc_counts))
    inv = 1.0 / shares.replicas

    metrics: dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=enc_out.device)
    if config.encoder_type == "conformer" and (config.conformer or ConformerConfig()).moe_experts:
        # already weighted (moe_aux_weight, moe_zloss_weight): keeps the
        # router balanced across experts
        aux_share = moe_aux / shares.size
        total = total + aux_share
        metrics["moe_aux"] = aux_share
    for head in config.aux_heads:
        head_params = params["aux"][head.name]
        h = enc_out
        for mlp in head_params["mlp"]:
            h = torch.relu(_dense(mlp, h, config.compute_dtype))
        pred = _dense(head_params["out"], h, config.compute_dtype)
        raw = batch[head.name]
        scale = penalty_scales.get(head.name, 1.0)
        if head.distribution == "CTC":
            # alignment-free phoneme loss (models/ctc.py); pred covers the
            # phonemes and the trailing blank
            loss = inv * ctc_loss(pred, enc_lengths, raw, batch[f"{head.name}_lengths"],
                                  ctc_counts[head.name] if shares.dp is not None else None)
            metrics[f"loss_{head.name}"] = loss
            total = total + scale * loss
            continue
        if head.distribution not in ("categorical", "Gaussian", "Rayleigh"):
            raise ValueError(
                f"aux head {head.name!r}: unknown distribution "
                f"{head.distribution!r} (expected 'categorical', 'CTC', "
                "'Gaussian', or 'Rayleigh')"
            )
        aligned = _decimate_targets(
            raw.transpose(0, 1), batch["encoder_lengths"],
            config.decimation_factor, T_out,
            reverse=config.encoder_type != "conformer",
        )
        if head.distribution == "categorical":
            logp = torch.log_softmax(pred, dim=-1)
            values = -torch.gather(logp, -1, aligned.long()[..., None])[..., 0]
        elif head.distribution == "Gaussian":  # masked MSE
            values = ((pred - aligned) ** 2).sum(dim=-1)
        else:  # Rayleigh: the head predicts log σ per feature
            values = rayleigh_nll(pred, aligned).sum(dim=-1)
        loss = inv * _masked_mean(values, step_mask, step_count)
        metrics[f"loss_{head.name}"] = loss
        total = total + scale * loss

    logits = decoder_teacher_forcing(
        params, config, enc_final, targets, generator, train,
        enc_out=enc_out, enc_lengths=enc_lengths,
    )  # (L, B, V)
    t_lb = targets.long().transpose(0, 1)  # (L, B)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, t_lb[..., None])[..., 0]
    dec_loss = inv * _masked_mean(nll, dec_mask, dec_count)
    total = total + penalty_scales.get("decoder_targets", 1.0) * dec_loss
    metrics["loss_decoder"] = dec_loss
    correct = (torch.argmax(logits, dim=-1) == t_lb).float()
    metrics["token_accuracy"] = inv * _masked_mean(correct, dec_mask, dec_count)
    metrics["loss_total"] = total
    return total, shares.metrics(metrics)


def greedy_decode(
    params: dict,
    config: Seq2SeqConfig,
    inputs: torch.Tensor,  # (B, T, C)
    lengths: torch.Tensor,
    subject_idx,
    generator: torch.Generator | None = None,
    temperature: float | None = None,
) -> torch.Tensor:
    """Free-running decode to ``max_dec_len``: argmax when temperature is
    0/None, else temperature sampling.  Fixed length with a finished
    mask (EOS reached → emits pad).  Returns (B, max_dec_len) int32."""
    if temperature is None:
        temperature = config.temperature
    enc_out, enc_final, enc_lengths = encode(
        params, config, inputs, lengths, subject_idx
    )
    return decode_from_encoder(
        params, config, enc_out, enc_final, enc_lengths, generator, temperature
    )


def decode_from_encoder(
    params: dict,
    config: Seq2SeqConfig,
    enc_out: torch.Tensor,  # (T', B, E)
    enc_final,
    enc_lengths: torch.Tensor,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
) -> torch.Tensor:
    """Free-running decode from already-computed encoder state.

    Sampling draws Gumbel noise from ``generator``, which must live on
    the device of ``enc_out`` (seed 0 there when None)."""
    decoder = params["decoder"]
    states = _decoder_init_state(params, config, enc_final)
    B = enc_out.shape[1]
    dev = enc_out.device
    sample = bool(temperature) and temperature > 0
    if sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    token = torch.full((B,), config.pad_id, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    tokens = []
    for _ in range(config.max_dec_len):
        out = decoder["embedding"][token]  # (B, E)
        new_states = []
        for layer, st in zip(decoder["rnn"], states):
            st_new, out = lstm_step(layer, st, out, None, config.compute_dtype)
            new_states.append(st_new)
        states = new_states
        if config.use_attention:
            out = _attend(
                decoder["attn"], out, enc_out, enc_lengths, config.compute_dtype
            )
        logits = _dense(decoder["out"], out, config.compute_dtype)  # (B, V)
        if sample:
            u = torch.rand(logits.shape, generator=generator, device=dev)
            u = u.clamp_min(torch.finfo(u.dtype).tiny)
            nxt = torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        emitted = torch.where(finished, config.pad_id, nxt)
        finished = finished | (nxt == config.eos_id)
        token = emitted
        tokens.append(emitted)
    return torch.stack(tokens, dim=1).to(torch.int32)  # (B, L)
