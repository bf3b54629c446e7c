"""Sequence parallelism for the conformer encoder.

The port's counterpart of ``ecog2txt_tpu/parallel/sequence.py``.  The
chunked-causal conformer has a bounded compound receptive field behind a
chunk-aligned position (``models.conformer.receptive_field_steps``), so
its time axis shards over the ranks of a mesh axis:

* rank k of the axis holds the steps ``[k·S, (k+1)·S)`` (S a multiple of
  the attention chunk, so chunk boundaries align across shards);
* each rank takes its halo, the ``halo`` input steps before its shard,
  from the input it holds whole (JAX's sharded input needs a ``ppermute``
  of each shard's tail to its right neighbour instead); the first shard's
  halo is zeros.  Nothing crosses the axis before the gather;
* each rank encodes ``[halo, local]`` from absolute position
  ``k·S − halo`` with ``mask_invalid=True`` (the first shard's zeros sit
  at negative positions and behave as the offline zero pad), then drops
  the halo rows;
* the shards' outputs are gathered over the axis (``all_gather``, whose
  adjoint is a reduce-scatter), so every rank holds the full output.

The MoE router statistics count only each rank's own span (``stats_start
= k·S``: the halo rows are computed, not counted) and are summed over the
axis before the nonlinear aux loss, so the sharded aux equals the
unsharded one.  Under ``ep_axis`` (the ep×sp mesh) the expert leaves of
``params`` hold this rank's experts (``parallel/expert.py``) and the
combine is summed over that axis; the statistics are not, since the
replicated router gives every rank of it the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .comm import all_gather, all_reduce_tree


def halo_steps(config) -> int:
    """Input halo each shard needs from its left neighbour: the stack's
    compound receptive field behind a chunk-aligned shard boundary (a
    whole number of attention chunks)."""
    from ..models.conformer import receptive_field_steps

    return receptive_field_steps(config)


def check_shards(config, T: int, n: int) -> tuple[int, int]:
    """(S, halo) for T steps over n shards, or the ``ValueError`` of the
    JAX package's conditions: T a multiple of n·chunk, S at least the halo,
    and under the capacity MoE dispatch groups that align with the shards
    (``moe_group_size`` dividing S and the halo)."""
    halo = halo_steps(config)
    if T % (n * config.chunk_size):
        raise ValueError(f"T={T} must be a multiple of n·chunk_size={n * config.chunk_size}")
    S = T // n
    if config.moe_experts and config.moe_capacity_factor > 0:
        # capacity drops depend on each dispatch group's population, so a
        # shard's groups must be the offline groups: fixed segments whose
        # absolute boundaries every window [k·S − halo, k·S + S) lands on
        seg = int(getattr(config, "moe_group_size", 0) or 0)
        if not seg or S % seg or halo % seg:
            raise ValueError(
                "sequence parallelism with the capacity MoE path needs "
                "shard-aligned dispatch groups: set moe_group_size to a "
                f"divisor of both the per-shard steps ({S}) and the "
                f"halo ({halo}); got moe_group_size={seg or 0}.  "
                "(moe_group_size=0 groups per padded row — population "
                "differs between a halo window and the offline encode.)"
            )
    if S < halo:
        raise ValueError(
            f"per-shard steps {S} < halo {halo}: use fewer shards "
            f"(or this recording is too short for sequence parallelism)"
        )
    return S, halo


def sequence_parallel_encode(
    params: dict,
    config,
    xs: torch.Tensor,  # (B, T, in_dim): already downsampled features
    mesh,
    axis: str = "seq",
    lengths: torch.Tensor | None = None,
    compute_dtype=torch.float32,
    return_aux: bool = False,
    ep_axis: str | None = None,
    stats_axes: tuple[str, ...] | None = None,
):
    """Encode ``xs`` with its time axis sharded over ``mesh``'s ``axis``.

    ``xs`` is the whole (B, T, in_dim) input, the same on every rank of the
    axis (each rank takes its shard of it); returns the (B, T, D) output,
    gathered over the axis, equal to the unsharded ``conformer_encode``.
    Requires ``T % (n·chunk) == 0`` and per-shard steps ≥ the halo; pad
    the recording to the chunk grid first and pass ``lengths`` to mask the
    pad.  ``return_aux=True`` (MoE conformer) also returns the weighted
    router aux loss from the statistics summed over ``stats_axes``
    (default: ``axis``; a data-parallel caller adds ``'data'``).
    ``ep_axis``: a mesh axis over which the expert leaves of ``params``
    are sharded."""
    from ..models.conformer import moe_aux_from_stats

    if ep_axis is not None and not config.moe_experts:
        raise ValueError("ep_axis requires a MoE conformer (moe_experts)")
    group = mesh.group(axis)
    n, k = mesh.shape[axis], mesh.coord(axis)
    B, T, _ = xs.shape
    S, halo = check_shards(config, T, n)
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.long, device=xs.device)
    x_local = xs[:, k * S:(k + 1) * S]
    # the halo from the whole input; the first shard's zeros are masked out
    # by their negative absolute positions.  Its gradient reaches xs on
    # this rank: a caller that made xs alike on every rank (the replicated
    # subsample conv) sums the leaves' gradients over the ranks, which
    # counts it once, as the ppermute's adjoint would.
    prev_tail = (xs[:, k * S - halo:k * S] if k else
                 xs.new_zeros((B, halo, xs.shape[2])))
    out, stats = encode_shard(
        params, config, x_local, prev_tail, k * S, lengths, compute_dtype,
        ep_axis=mesh.group(ep_axis) if ep_axis is not None else None,
    )
    out = all_gather(out, group, 1)
    if not return_aux:
        return out
    # over the time shards (and the data ranks, for a dp caller) only: the
    # replicated router gives every ep_axis rank the same statistics
    stats = all_reduce_tree(stats, mesh.group(*(stats_axes or (axis,))))
    return out, moe_aux_from_stats(config, stats, out.device)


def encode_shard(params: dict, config, x_local: torch.Tensor, prev_tail: torch.Tensor,
                 start: int, lengths: torch.Tensor, compute_dtype=torch.float32, ep_axis=None):
    """One shard's work: encode ``[prev_tail, x_local]`` from absolute
    position ``start − halo`` with the pre-recording positions masked, and
    drop the halo rows.  Returns (out (B, S, D), the per-block router
    statistics counting positions from ``start`` on)."""
    from ..models.conformer import conformer_encode

    halo = prev_tail.shape[1]
    window = torch.cat([prev_tail, x_local], dim=1)
    out, _, stats = conformer_encode(
        params, config, window, lengths, position_offset=start - halo,
        compute_dtype=compute_dtype, mask_invalid=True, return_moe_stats=True,
        stats_start=start, ep_axis=ep_axis,
    )
    return out[:, halo:], stats


def pad_to_shards(xs_bm: torch.Tensor, mesh, axis: str, chunk: int) -> torch.Tensor:
    """``xs_bm`` (B, T, F) padded with zero steps to a multiple of the
    axis's ranks times ``chunk`` (the pad sits beyond every length)."""
    mult = mesh.shape[axis] * chunk
    pad = (-xs_bm.shape[1]) % mult
    return F.pad(xs_bm, (0, 0, 0, pad)) if pad else xs_bm
