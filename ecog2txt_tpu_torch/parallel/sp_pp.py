"""Sequence parallelism composed with pipeline parallelism (sp × pp).

The port's counterpart of ``ecog2txt_tpu/parallel/sp_pp.py``: long
recordings and a deep block stack.  The time axis shards over a ``seq``
mesh axis with the one-input-halo windows of ``parallel/sequence.py``
(each rank encodes ``[halo, local]`` from its absolute position and drops
the halo rows), and the block stack pipelines over a ``pp`` axis with the
GPipe ring of ``parallel/pipeline.py``.  The two communicate on disjoint
groups: the window is cut from the input every rank holds (no
communication), the ring shifts activations along ``pp`` once a tick, and
the shards' outputs are gathered along ``seq`` at the end.

Every (seq, pp) rank holds one stage's blocks and runs them on its shard's
window; a ``data`` axis splits the batch rows and ``ep_axis`` the MoE
experts inside every stage (ep × sp × pp); under tensor parallelism (tp ×
sp × pp) the blocks come in whole, their columns gathered before the
encode (``models/seq2seq.py``).  The router statistics leave the halo out (``stats_start``)
and are summed over ``data`` and ``seq`` before the per-block loss, then
over the ring.
"""

from __future__ import annotations

import torch

from .comm import all_gather
from .pipeline import _check_axes, _stage_blocks, check_microbatches, ring_aux, run_ring
from .sequence import check_shards


def sp_pp_conformer_encode(
    params: dict,
    config,
    xs: torch.Tensor,  # (B, T, in_dim): already downsampled features
    mesh,
    seq_axis: str = "seq",
    pp_axis: str = "pp",
    microbatches: int | None = None,
    lengths: torch.Tensor | None = None,
    compute_dtype=torch.float32,
    return_aux: bool = False,
    ep_axis: str | None = None,
):
    """Encode with time sharded over ``mesh``'s ``seq_axis`` and the block
    stack pipelined over its ``pp_axis``.

    ``xs`` is the whole (B, T, in_dim) input of this rank's rows, the same
    on every rank of the ``seq`` axis; returns the (B, T, D) output on every
    rank (the unsharded encode's values), with ``return_aux`` also the
    weighted router aux loss.  The conditions are both parents': ``T`` a
    multiple of n_seq·chunk, the shards at least the halo (and the capacity
    MoE's dispatch groups aligned with them), the blocks split over the
    stages and the rows over ``microbatches`` (default: the stages)."""
    from ..models.conformer import _positions, in_projection

    _check_axes(config, ep_axis)
    S_pp = mesh.shape[pp_axis]
    M = microbatches or S_pp
    B, T, _ = xs.shape
    n, k = mesh.shape[seq_axis], mesh.coord(seq_axis)
    S, halo = check_shards(config, T, n)
    check_microbatches(B, M)
    blocks = _stage_blocks(params, None, config, S_pp, mesh.coord(pp_axis))
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.long, device=xs.device)
    # the window from the input this rank holds whole; the first shard's
    # halo is zeros at negative positions, masked as the offline zero pad
    prev_tail = xs[:, k * S - halo:k * S] if k else xs.new_zeros((B, halo, xs.shape[2]))
    window = torch.cat([prev_tail, xs[:, k * S:(k + 1) * S]], dim=1)
    offset = k * S - halo
    x = in_projection(params, window, compute_dtype)
    valid = _positions(x.shape[1], offset, x.device) >= 0
    out, stats = run_ring(blocks, config, x, lengths, mesh, pp_axis, M, compute_dtype,
                          offset=offset, valid=valid, stats_start=k * S, ep_axis=ep_axis)
    out = all_gather(out[:, halo:], mesh.group(seq_axis), 1)
    if not return_aux:
        return out
    if stats is None:
        return out, torch.zeros((), device=out.device)
    return out, ring_aux(config, stats, mesh, pp_axis, ("data", seq_axis))
