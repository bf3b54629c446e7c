"""Conformer encoder: the chunked-causal alternative to the biLSTM stack.

The twin of ``ecog2txt_tpu/models/conformer.py`` with the same parameter
tree (``init_conformer``: nested dicts and lists, the same keys and
shapes, weights stored (in, out)) and the same functions:

* N blocks of ``x + ½FFN → x + MHSA → x + ConvModule → x + ½FFN →
  LayerNorm`` over the downsampled steps, batch-major ``(B, T, D)``;
* attention is chunked-causal (queries see their chunk and
  ``left_context`` chunks before it, chunk ids from ABSOLUTE positions)
  with rotary q/k; four implementations of the same function:
  ``dense`` (the (T, T) oracle), ``banded`` (the band only, plain
  PyTorch), ``flash`` (the Hopper kernels K2f / K2b through
  ``ops.attention_kernels.banded_flash_attention``) and ``fused`` (K3f:
  LayerNorm, projections, rotary and attention in one kernel, K2b in its
  backward).  Under ``'auto'`` up to 256 steps run ``dense``; longer
  sequences run ``flash`` on a CUDA tensor and ``banded`` on a CPU one;
* every LayerNorm outside K3f runs the Hopper kernels K5f / K5b
  (``ops.layernorm_kernels.layer_norm``) on a CUDA tensor;
* the conv module is depthwise-causal (left padding only) with a
  ``kernel-1`` step tail for streaming;
* :class:`ConformerStream` re-encodes a fixed window that covers the
  stack's receptive field, so streamed chunks equal the offline encode.

``moe_experts > 0`` replaces each block's second FFN with the routed
mixture of experts of ``models.moe`` (its LayerNorm on K5f / K5b like
every other); the blocks return their router statistics and
``conformer_encode(..., return_aux=True)`` the weighted aux loss.  A
weight rewritten by ``quantize.quantize_conformer_params`` (a
:class:`quantize.QuantizedWeight`) makes its product int8 x int8 → int32
(``quantize.int8_dot``); under int8 weights 'fused' runs 'flash', the
same function, because K3f reads the float ``wqkv``.

Products take both operands in ``compute_dtype`` and return it (f32
accumulation inside); LayerNorm statistics and the attention softmax
stay f32.

Sequence and pipeline parallelism (``parallel/sequence.py``,
``parallel/pipeline.py``, ``parallel/sp_pp.py``) call :func:`apply_block`
and :func:`conformer_encode` with their shard's positions; tensor
parallelism gathers the split weights before the encode
(``models/seq2seq.py``), so nothing here knows of it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..convert import tree_map
from ..ops.attention_kernels import banded_flash_attention, fused_attention_layer
from ..ops.layernorm_kernels import layer_norm, layer_norm_fwd_reference
from ..quantize import QuantizedWeight, int8_dot
from .moe import aux_from_stats, glorot, init_moe_ffn, moe_ffn


@dataclass(frozen=True)
class ConformerConfig:
    num_blocks: int = 4
    model_dim: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    conv_kernel: int = 8
    chunk_size: int = 16  # attention chunk (in downsampled steps)
    left_context: int = 1  # chunks of look-back
    # 'auto' | 'dense' | 'banded' | 'flash' | 'fused'; all compute the
    # same function ('auto': dense up to _AUTO_DENSE_MAX_STEPS steps,
    # then flash on CUDA tensors, banded on CPU tensors)
    attention_impl: str = "auto"
    # banded tiling: query blocks of this many chunks (None → ~128 rows)
    query_block_chunks: int | None = None
    # recompute each block in the backward (torch.utils.checkpoint)
    remat: bool = False
    # mixture-of-experts second FFN (models/moe.py): > 0 routes each
    # token to moe_topk of moe_experts experts; moe_capacity_factor 0 is
    # the exact no-drop path (streams), > 0 the capacity path with
    # dispatch groups of moe_group_size steps (0: one group a row)
    moe_experts: int = 0
    moe_topk: int = 2
    moe_capacity_factor: float = 0.0
    moe_group_size: int = 0
    moe_aux_weight: float = 1e-2
    moe_zloss_weight: float = 1e-3

    def __post_init__(self):
        if self.attention_impl not in _IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r}: expected one of {_IMPLS}"
            )


_IMPLS = ("auto", "dense", "banded", "flash", "fused")
# the JAX package's dense/banded crossover, kept as it is
_AUTO_DENSE_MAX_STEPS = 256


def init_conformer(
    generator: torch.Generator, config: ConformerConfig, in_dim: int, device="cuda"
) -> dict:
    """Parameter tree in the JAX layout, drawn from the CPU ``generator``
    and placed on ``device``."""
    dev = resolve_device(device)
    g = generator
    D, Fd, K = config.model_dim, config.ffn_dim, config.conv_kernel
    zeros = lambda n: torch.zeros((n,))  # noqa: E731
    ln = lambda: {"g": torch.ones((D,)), "b": zeros(D)}  # noqa: E731

    def ffn():
        return {
            "w1": glorot(g, (D, Fd)), "b1": zeros(Fd),
            "w2": glorot(g, (Fd, D)), "b2": zeros(D), "ln": ln(),
        }

    params: dict = {
        "in_proj": {"w": glorot(g, (in_dim, D)), "b": zeros(D)},
        "blocks": [],
    }
    for _ in range(config.num_blocks):
        params["blocks"].append({
            "ffn1": ffn(),
            "attn": {
                "wqkv": glorot(g, (D, 3 * D)),
                "wo": glorot(g, (D, D)),
                "ln": ln(),
            },
            "conv": {
                # pointwise → GLU → depthwise causal → pointwise
                "pw1": glorot(g, (D, 2 * D)),
                "dw": 0.1 * torch.randn((K, D), generator=g),
                "pw2": glorot(g, (D, D)),
                "ln": ln(),
            },
            "ffn2": (init_moe_ffn(g, D, Fd, config.moe_experts)
                     if config.moe_experts else ffn()),
            "ln_out": ln(),
        })
    return tree_map(lambda a: a.to(dev), params)


def _dot(x: torch.Tensor, w, cd) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to the stream dtype ``cd`` (``x`` is in
    it already): a product in ``cd`` with f32 accumulation; int8 x int8 →
    int32 when ``w`` is a :class:`quantize.QuantizedWeight`."""
    if isinstance(w, QuantizedWeight):
        return int8_dot(x, w, cd)
    return torch.matmul(x, w.to(cd))


def _layernorm(p, x, eps=1e-6):
    """Statistics in f32 whatever the stream dtype; the result is cast
    back so the products after it stay in the stream dtype.  A CUDA
    tensor goes through the Hopper kernels (forward K5f, backward K5b);
    a CPU tensor through the plain math."""
    if x.is_cuda:
        return layer_norm(x, p["g"], p["b"], eps)
    return layer_norm_fwd_reference(x, p["g"], p["b"], eps)


def _ffn(p, x, cd):
    h = F.silu(_dot(_layernorm(p["ln"], x), p["w1"], cd) + p["b1"].to(cd))
    return _dot(h, p["w2"], cd) + p["b2"].to(cd)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding over the head dim.  x: (B, T, H, Dh);
    positions: (T,), or (B, T) with per-row offsets.  Angles in f32, the
    rotation in the stream dtype."""
    Dh = x.shape[-1]
    half = Dh // 2
    freq = 1.0 / (10000.0 ** (torch.arange(half, device=x.device) / half))
    angles = positions.float()[..., None] * freq  # (T, half) or (B, T, half)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _chunk_causal_mask(positions: torch.Tensor, chunk: int, left_context: int):
    """(T, T) bool ((B, T, T) for per-row positions): the query at t sees
    keys in its own chunk and up to ``left_context`` chunks back, by
    ABSOLUTE position; keys at negative positions are invalid."""
    q_chunk = torch.div(positions[..., :, None], chunk, rounding_mode="floor")
    k_chunk = torch.div(positions[..., None, :], chunk, rounding_mode="floor")
    return (
        (k_chunk <= q_chunk)
        & (k_chunk >= q_chunk - left_context)
        & (positions[..., None, :] >= 0)
    )


def _per_row(offset) -> bool:
    """Whether ``offset`` gives each batch row its own position offset."""
    return torch.is_tensor(offset) and offset.dim() == 1


def _positions(T: int, offset, device) -> torch.Tensor:
    """Absolute positions of T steps: (T,) from an int offset, (B, T) from
    a (B,) tensor of per-row offsets."""
    if _per_row(offset):
        return offset.to(device=device, dtype=torch.long)[:, None] + torch.arange(
            T, device=device
        )
    return torch.arange(T, device=device) + offset


def _qkv(p, x, config: ConformerConfig, offset: int, cd):
    """LayerNorm → the qkv product → rotary: (q, k, v) each (B, T, H, Dh)."""
    B, T, D = x.shape
    H = config.num_heads
    qkv = _dot(_layernorm(p["ln"], x), p["wqkv"], cd).reshape(B, T, 3, H, D // H)
    positions = _positions(T, offset, x.device)
    return _rotary(qkv[:, :, 0], positions), _rotary(qkv[:, :, 1], positions), qkv[:, :, 2]


def _attention_dense(p, x, config: ConformerConfig, lengths, offset: int, cd):
    """Parity oracle: the full (T, T) score matrix under the chunk-causal
    mask.  O(T²)."""
    B, T, D = x.shape
    Dh = D // config.num_heads
    q, k, v = _qkv(p, x, config, offset, cd)
    positions = _positions(T, offset, x.device)
    # scores in the stream dtype, softmax in f32; head-minor (b, t, s, h)
    logits = torch.einsum("bthd,bshd->btsh", q, k).float() / np.sqrt(Dh)
    mask = _chunk_causal_mask(positions, config.chunk_size, config.left_context)
    if mask.dim() == 2:
        mask = mask[None]
    if lengths is not None:
        mask = mask & (positions[..., None, :] < lengths[:, None, None])
    mask = mask[..., None]  # (B or 1, T, S, 1)
    logits = torch.where(mask, logits, -1e9)
    attn = torch.softmax(logits, dim=2).to(cd)
    out = torch.einsum("btsh,bshd->bthd", attn, v).reshape(B, T, D)
    return _dot(out, p["wo"], cd)


def _attention_banded(p, x, config: ConformerConfig, lengths, offset: int, cd):
    """Chunk-causal attention computed on the band only: query blocks of
    ``Q`` chunks against a ``(Q + left_context)``-chunk key window, so
    the scores are (B, H, NB, Q·C, W): O(T·window).  The same function
    as :func:`_attention_dense`; window slots before the sequence or in
    the trailing pad carry a sentinel position -1 and are masked."""
    B, T, D = x.shape
    H = config.num_heads
    Dh = D // H
    C, L = config.chunk_size, config.left_context
    Q = config.query_block_chunks or max(1, 128 // C)
    Q = min(Q, -(-T // C))  # no block larger than the sequence
    q, k, v = _qkv(p, x, config, offset, cd)
    positions = _positions(T, offset, x.device)
    pad = (-T) % (Q * C)
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    Tp = T + pad
    NB = Tp // (Q * C)
    W = (Q + L) * C
    qb = q.reshape(B, NB, Q * C, H, Dh)

    def windows(a):
        # the L·C rows before each block (front-padded) + the block's own
        blocks = a.reshape(B, NB, Q * C, *a.shape[2:])
        front = F.pad(a[:, : Tp - L * C or None], (0, 0) * (a.dim() - 2) + (L * C, 0))
        prev = front[:, : NB * Q * C].reshape(B, NB, Q * C, *a.shape[2:])[:, :, : L * C]
        return torch.cat([prev, blocks], dim=2)

    kw, vw = windows(k), windows(v)
    # key positions by window, (P, NB, W): P = B for per-row offsets, else 1
    pos = positions if positions.dim() == 2 else positions[None]
    P = pos.shape[0]
    sentinel = torch.full((P, pad), -1, dtype=pos.dtype, device=x.device)
    pos_ext = torch.cat([pos, sentinel], dim=1)
    front = torch.cat([
        torch.full((P, L * C), -1, dtype=pos.dtype, device=x.device),
        pos_ext[:, : Tp - L * C or None],
    ], dim=1)[:, : NB * Q * C]
    kposw = torch.cat(
        [front.reshape(P, NB, Q * C)[:, :, : L * C], pos_ext.reshape(P, NB, Q * C)], dim=2
    )
    logits = torch.einsum("bnchd,bnwhd->bhncw", qb, kw).float() / np.sqrt(Dh)
    # intra-tile band: query local chunk qi sees window chunk kj iff
    # qi <= kj <= qi + L
    qi = torch.arange(Q * C, device=x.device)[:, None] // C
    kj = torch.arange(W, device=x.device)[None, :] // C
    band = (kj >= qi) & (kj <= qi + L)  # (Q·C, W)
    mask = band & (kposw[:, :, None, :] >= 0)  # (P, NB, Q·C, W)
    if lengths is not None:
        mask = mask & (kposw[:, :, None, :] < lengths[:, None, None, None])
    mask = mask[:, None]  # (B or 1, 1, NB, Q·C, W)
    logits = torch.where(mask, logits, -1e9)
    attn = torch.softmax(logits, dim=-1).to(cd)
    out = torch.einsum("bhncw,bnwhd->bnchd", attn, vw).reshape(B, Tp, D)[:, :T]
    return _dot(out, p["wo"], cd)


def _scalar_offset(impl: str, offset) -> None:
    """The kernels take one offset for the batch: refuse per-row ones."""
    if _per_row(offset):
        raise ValueError(
            f"attention_impl={impl!r} takes one int position offset; per-row "
            "offsets run the plain 'dense' or 'banded' attention"
        )


def _attention_flash(p, x, config: ConformerConfig, lengths, offset: int, cd):
    """The banded attention through the Hopper kernels (forward K2f,
    backward K2b); queries are contiguous from ``offset``."""
    _scalar_offset("flash", offset)
    B, T, D = x.shape
    q, k, v = _qkv(p, x, config, offset, cd)
    out = banded_flash_attention(
        q, k, v, offset, lengths,
        chunk_size=config.chunk_size, left_context=config.left_context,
    )
    return _dot(out.reshape(B, T, D), p["wo"], cd)


def _attention_fused(p, x, config: ConformerConfig, lengths, offset: int, cd):
    """LayerNorm → qkv → rotary → banded attention in one kernel (K3f);
    the output projection and the residual stay outside.  The f32
    ``wqkv`` and LayerNorm parameters go in as they are (cast inside)."""
    _scalar_offset("fused", offset)
    att = fused_attention_layer(
        p["wqkv"], p["ln"]["g"], p["ln"]["b"], x, offset, lengths,
        chunk_size=config.chunk_size, left_context=config.left_context,
        num_heads=config.num_heads,
    )
    return _dot(att, p["wo"], cd)


_ATTENTION_IMPLS = {
    "dense": _attention_dense,
    "banded": _attention_banded,
    "flash": _attention_flash,
    "fused": _attention_fused,
}


def _attention(p, x, config: ConformerConfig, lengths, offset: int, cd):
    impl = config.attention_impl
    if impl == "fused" and isinstance(p["wqkv"], QuantizedWeight):
        # K3f reads the float wqkv; under int8 weights 'flash' is the same
        # function
        impl = "flash"
    if impl == "auto":
        if x.shape[1] <= _AUTO_DENSE_MAX_STEPS:
            impl = "dense"
        else:
            impl = "flash" if x.is_cuda and not _per_row(offset) else "banded"
    return _ATTENTION_IMPLS[impl](p, x, config, lengths, offset, cd)


def _conv_module(p, x, tail=None, cd=torch.float32, valid=None):
    """Depthwise-causal conv module.  ``tail``: (B, K-1, D) carried
    samples; ``valid``: (T,) bool, or (B, T) for per-row offsets, zeroing
    steps at negative positions so their taps equal the offline encode's
    zero left-pad.  Returns (out, new_tail)."""
    B, T, D = x.shape
    K = p["dw"].shape[0]
    h = F.glu(_dot(_layernorm(p["ln"], x), p["pw1"], cd), dim=-1)  # (B, T, D)
    if valid is not None:
        h = h * (valid if valid.dim() == 2 else valid[None])[..., None].to(h.dtype)
    if tail is None:
        tail = torch.zeros((B, K - 1, D), dtype=h.dtype, device=h.device)
    h_padded = torch.cat([tail, h], dim=1)  # (B, T+K-1, D)
    # as in the JAX package: one grouped convolution at large B·T, K
    # shifted adds at small B·T (they differ in summation order only).  A
    # symbolic batch (``torch.export``) cannot decide the crossover: it
    # takes the convolution, the branch of every batch at scale, as JAX
    # does (a guard on the batch would contradict the exported range)
    if isinstance(B, torch.SymInt) or torch.compiler.is_exporting() or B * T >= 4096:
        kernel = p["dw"].to(cd).T[:, None, :]  # (D, 1, K)
        out = F.conv1d(h_padded.transpose(1, 2), kernel, groups=D).transpose(1, 2)
    else:
        out = torch.zeros_like(h)
        for k in range(K):
            out = out + h_padded[:, k : k + T] * p["dw"][k].to(cd)
    out = _dot(F.silu(out), p["pw2"], cd)
    return out, h_padded[:, T:]


def apply_block(block, x, config: ConformerConfig, lengths, offset: int,
                cd=torch.float32, tail=None, valid=None, stats_start=None, ep_axis=None):
    """One block (½FFN → MHSA → conv → ½FFN → LN): (x, new_conv_tail,
    moe_stats), the stats the block's additive router statistics
    (``models.moe.router_stats``), None without MoE.  ``stats_start``: the
    first absolute position the statistics count (sequence parallelism's
    halo is computed but not counted); ``ep_axis``: the MoE FFN's expert
    parallelism (a process group)."""
    x = x + 0.5 * _ffn(block["ffn1"], x, cd)
    x = x + _attention(block["attn"], x, config, lengths, offset, cd)
    conv_out, new_tail = _conv_module(block["conv"], x, tail, cd, valid)
    x = x + conv_out
    stats = None
    if config.moe_experts:
        # tokens inside the recording (absolute position in [0, length),
        # per row under per-row offsets): the others take no capacity and
        # do not count in the statistics
        B, T = x.shape[0], x.shape[1]
        positions = _positions(T, offset, x.device)
        tok_valid = (positions >= 0).expand(B, T)
        if lengths is not None:
            tok_valid = tok_valid & (positions < lengths[:, None])
        stats_valid = None if stats_start is None else tok_valid & (positions >= stats_start)
        moe_out, stats = moe_ffn(block["ffn2"], _layernorm(block["ffn2"]["ln"], x),
                                 config, cd, tok_valid, stats_valid, ep_axis)
        x = x + 0.5 * moe_out
    else:
        x = x + 0.5 * _ffn(block["ffn2"], x, cd)
    return _layernorm(block["ln_out"], x), new_tail, stats


def conformer_encode(
    params: dict,
    config: ConformerConfig,
    xs: torch.Tensor,  # (B, T, in_dim): already downsampled features
    lengths: torch.Tensor | None = None,
    position_offset: int | torch.Tensor = 0,
    carry: list | None = None,
    compute_dtype=torch.float32,
    mask_invalid: bool = False,
    return_aux: bool = False,
    return_moe_stats: bool = False,
    stats_start: int | None = None,
    ep_axis=None,
):
    """Full-sequence (training) or continuation (streaming) encode.

    ``position_offset`` is the absolute position of step 0 (an int,
    chunk-aligned), or a (B,) tensor of chunk-aligned per-row offsets
    (what the JAX package gets by ``vmap``-ping one window over the slots
    of a serving pool), which only the plain 'dense' and 'banded'
    attention take; ``carry`` the per-block conv tails; ``mask_invalid``
    zeroes the conv input at negative positions.  Returns (out (B, T, D),
    new_carry); with ``return_aux`` also the mean weighted router aux
    loss over the MoE blocks (0 without MoE), with ``return_moe_stats``
    instead the per-block list of router statistics (None for a block
    without MoE), which sharded callers sum over their shards before
    :func:`moe_aux_from_stats`.  ``stats_start`` leaves positions below it
    out of the statistics (not out of the outputs); ``ep_axis`` (a process
    group) runs the MoE FFN expert-parallel (``models/moe.py``).  ``remat``
    recomputes each block in the backward."""
    cd = compute_dtype
    x = in_projection(params, xs, cd)
    offset = position_offset if _per_row(position_offset) else int(position_offset)
    valid = _positions(x.shape[1], offset, x.device) >= 0 if mask_invalid else None
    new_carry, stats_list = [], []
    for bi, block in enumerate(params["blocks"]):
        tail = carry[bi] if carry is not None else None
        if config.remat and torch.is_grad_enabled():
            x, new_tail, stats = checkpoint(
                apply_block, block, x, config, lengths, offset, cd, tail, valid,
                stats_start, ep_axis, use_reentrant=False,
            )
        else:
            x, new_tail, stats = apply_block(block, x, config, lengths, offset, cd, tail,
                                             valid, stats_start, ep_axis)
        new_carry.append(new_tail)
        stats_list.append(stats)
    if return_moe_stats:
        return x, new_carry, stats_list
    if return_aux:
        return x, new_carry, moe_aux_from_stats(config, stats_list, x.device)
    return x, new_carry


def in_projection(params: dict, xs: torch.Tensor, cd) -> torch.Tensor:
    """The input projection ``xs @ in_proj.w + b`` in the stream dtype."""
    return _dot(xs.to(cd), params["in_proj"]["w"], cd) + params["in_proj"]["b"].to(cd)


def moe_aux_from_stats(config: ConformerConfig, stats_list, device=None) -> torch.Tensor:
    """Mean weighted router aux loss over the MoE blocks, from their
    additive statistics (``None`` entries are blocks without MoE)."""
    losses = [aux_from_stats(config, s) for s in stats_list if s is not None]
    if not losses:
        return torch.zeros((), device=device)
    return sum(losses) / len(losses)


def receptive_field_steps(config: ConformerConfig) -> int:
    """Compound receptive field of the block stack behind a chunk-aligned
    position, in encoder steps (a multiple of ``chunk_size``): per block
    ``left_context`` chunks of attention plus the chunks the conv's
    ``kernel-1`` taps reach into."""
    C = config.chunk_size
    conv_chunks = -(-(config.conv_kernel - 1) // C)  # 0 when kernel == 1
    return config.num_blocks * C * (config.left_context + conv_chunks)


class ConformerStream:
    """Chunk-by-chunk streaming by re-encoding a fixed window that covers
    the stack's receptive field (:func:`receptive_field_steps`) plus the
    emitted chunk.  The window starts on an absolute chunk boundary and
    its left zero-fill sits at negative positions, which ``mask_invalid``
    treats like the offline zero left-pad, so every emitted chunk equals
    the offline encode's rows."""

    def __init__(self, params: dict, config: ConformerConfig, compute_dtype=torch.float32):
        if config.moe_experts and config.moe_capacity_factor > 0:
            raise ValueError(
                "streaming requires the exact no-drop MoE path "
                "(moe_capacity_factor=0): capacity drops depend on the token "
                "population, and a streaming window's population differs from "
                "the offline encode's"
            )
        self.params = params
        self.config = config
        self.compute_dtype = compute_dtype
        self.window_steps = receptive_field_steps(config) + config.chunk_size
        self.reset()

    def reset(self):
        self._window: torch.Tensor | None = None  # (B, W, in_dim)
        self._pushed = 0
        self._valid = 0

    def snapshot(self) -> tuple:
        """Opaque state; :meth:`restore` it to undo speculative pushes."""
        return (self._window, self._pushed, self._valid)

    def restore(self, state: tuple) -> None:
        self._window, self._pushed, self._valid = state

    @torch.inference_mode()
    def push(self, chunk: torch.Tensor, num_valid: int | None = None) -> torch.Tensor:
        """chunk: (B, chunk_size, in_dim) → (B, chunk_size, D), this
        chunk's encoder output.  ``num_valid`` < chunk_size marks a FINAL
        partial chunk (padded to the chunk boundary): steps beyond it are
        masked out of attention, as the offline encode's lengths mask
        them.  After a partial push, ``reset()`` (or ``restore()``)."""
        cfg = self.config
        C = cfg.chunk_size
        if chunk.shape[1] != C:
            raise ValueError(f"push expects chunks of {C} steps")
        if self._valid < self._pushed:
            raise RuntimeError("push after a partial (final) chunk: reset() the stream")
        B, _, in_dim = chunk.shape
        if self._window is None:
            self._window = torch.zeros(
                (B, self.window_steps, in_dim), dtype=chunk.dtype, device=chunk.device
            )
        self._pushed += C
        self._valid += C if num_valid is None else int(num_valid)
        lengths = torch.full((B,), self._valid, dtype=torch.int32, device=chunk.device)
        offset = self._pushed - self.window_steps
        window = torch.cat([self._window[:, C:], chunk], dim=1)
        out, _ = conformer_encode(
            self.params, cfg, window, lengths, position_offset=offset,
            compute_dtype=self.compute_dtype, mask_invalid=True,
        )
        self._window = window
        return out[:, -C:]
