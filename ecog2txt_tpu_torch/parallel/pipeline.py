"""Pipeline parallelism for the conformer block stack.

The port's counterpart of ``ecog2txt_tpu/parallel/pipeline.py``.  The
conformer's blocks are homogeneous ``(B, T, D) → (B, T, D)`` maps with
their own weights (``models.conformer.apply_block``), so they pipeline as
a GPipe ring over the ranks of a ``pp`` mesh axis:

* the S ranks of the axis each hold one stage, ``num_blocks / S``
  consecutive blocks (:func:`shard_stages`), with their EMA and Adam
  moments: the memory win pipeline parallelism is for.  Every leaf outside
  the stages (the subnet, the input projection, the aux heads, the
  decoder) is replicated over ``pp``;
* the batch splits into M microbatches.  At tick t the rank of stage s
  runs its blocks on microbatch t − s (when there is one) and the ring
  shifts every stage's output one rank on (``parallel.comm.ring_shift``,
  JAX's ``ppermute``); after M + S − 1 ticks every microbatch has passed
  every stage.  Fill and drain ticks compute nothing: the bubble,
  (S − 1) / (M + S − 1) of the ticks, is idle time;
* the last stage's outputs are summed over the axis (the other stages
  contribute zeros), so every rank of the axis holds the encoder output
  and runs the decoder and the loss on it.

The ring is one ``torch.autograd.Function`` a call (``_RingFunction``
over the stage's schedule, ``_Ring``): its forward runs the ticks and
keeps each microbatch's graph; its backward
runs the ticks in reverse, each microbatch's blocks backward from the
cotangent the shift back brought (``ring_shift`` by −1, the shift's
adjoint), so every rank exchanges its tensors in the same order and no two
ranks wait on each other.  The stage leaves' gradients are summed over the
microbatches; the input's go back to stage 0.

The MoE router statistics of a stage are summed over its real ticks,
then over the ``data`` axis (and ``seq`` under sp × pp) before the
nonlinear per-block loss, and the stages' losses are summed over ``pp``:
the aux loss is the unsharded one.  Dispatch groups never cross batch
rows, so microbatching leaves the capacity drops as they are.  ``ep_axis``
runs each stage's MoE FFN expert-parallel.  Under tensor parallelism the
stage's blocks come in whole (``models/seq2seq.py`` gathers the split
columns before the encode).

``parallel/sp_pp.py`` runs the same ring over each time shard's window.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from ..convert import tree_leaves, tree_map
from .comm import _gather_pieces, all_reduce_sum, all_reduce_tree, ring_shift

# the additive router statistics of a MoE block, in a fixed order
# (models/moe.py::router_stats)
_STATS = ("fsum", "psum", "zsum", "n", "csum")


def _rebuild(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stack_block_params(params: dict, n_stages: int) -> dict:
    """``params['blocks']`` (the list of per-block dicts) → one tree whose
    leaves have leading ``(n_stages, blocks_per_stage)`` axes, as JAX
    stacks them to place one stage a device."""
    blocks = params["blocks"]
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} blocks do not split into {n_stages} stages")
    per_block = [tree_leaves(b) for b in blocks]
    stacked = [torch.stack(ls).reshape(n_stages, -1, *ls[0].shape) for ls in zip(*per_block)]
    return _rebuild(blocks[0], stacked)


def check_microbatches(B: int, M: int, n_data: int = 1) -> None:
    """JAX's conditions on the batch: B rows split into ``M`` microbatches,
    and each microbatch's rows over ``n_data`` data ranks; ``ValueError``
    otherwise."""
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if n_data > 1 and (B // M) % n_data:
        raise ValueError(f"microbatch size {B // M} does not shard over "
                         f"data axis of {n_data} devices")


def _holder(tree: dict) -> dict:
    """The dict that holds the conformer's ``blocks``: a seq2seq tree's
    ``encoder/conformer``, or the conformer tree itself."""
    return tree["encoder"]["conformer"] if "encoder" in tree else tree


def _with_blocks(tree: dict, blocks: list) -> dict:
    """A shallow copy of ``tree`` with ``blocks`` in place of its blocks."""
    if "encoder" in tree:
        conformer = {**tree["encoder"]["conformer"], "blocks": blocks}
        return {**tree, "encoder": {**tree["encoder"], "conformer": conformer}}
    return {**tree, "blocks": blocks}


def shard_stages(tree: dict, mesh, axis: str = "pp") -> dict:
    """This rank's placement of a whole tree (parameters, EMA, or a tree of
    marks of the same structure) under pipeline parallelism: the blocks of
    its stage only, every other leaf kept."""
    blocks = _holder(tree)["blocks"]
    S, s = mesh.shape[axis], mesh.coord(axis)
    if len(blocks) % S:
        raise ValueError(f"{len(blocks)} blocks do not split into {S} stages")
    per = len(blocks) // S
    return _with_blocks(tree, blocks[s * per:(s + 1) * per])


def gather_stages(tree: dict, mesh, axis: str = "pp") -> dict:
    """The inverse of :func:`shard_stages`: every stage's blocks gathered
    over ``axis`` in stage order (every rank of the axis takes part and
    gets the whole tree)."""
    group = mesh.group(axis)
    blocks = _holder(tree)["blocks"]
    S = mesh.shape[axis]
    by_stage: list[list] = [[] for _ in range(S)]
    with torch.no_grad():
        for block in blocks:
            pieces = [_gather_pieces(t.detach(), group) if S > 1 else [t.detach()]
                      for t in tree_leaves(block)]
            for s in range(S):
                by_stage[s].append(_rebuild(block, [p[s] for p in pieces]))
    return _with_blocks(tree, [b for stage in by_stage for b in stage])


def stage_mask(tree: dict) -> dict:
    """A tree of bools of ``tree``'s structure: which leaves belong to the
    pipelined blocks."""
    marked = tree_map(lambda _: False, tree)
    _holder(marked)["blocks"] = tree_map(lambda _: True, _holder(tree)["blocks"])
    return marked


class _Ring:
    """One stage's part of the GPipe ring: the static schedule, the
    stage's blocks and what their calls share."""

    def __init__(self, template: list, config, lengths: torch.Tensor, group, S: int, s: int,
                 M: int, cd, offset: int, valid, stats_start, ep):
        self.template, self.config, self.group = template, config, group
        self.S, self.s, self.M, self.cd = S, s, M, cd
        self.len_mb = lengths.reshape(M, -1)
        self.offset, self.valid, self.stats_start, self.ep = offset, valid, stats_start, ep
        self.moe = bool(config.moe_experts)

    def _stage(self, blocks: list, y: torch.Tensor, m: int):
        from ..models.conformer import apply_block

        stats = []
        for block in blocks:
            y, _, st = apply_block(block, y, self.config, self.len_mb[m], self.offset, self.cd,
                                   None, self.valid, self.stats_start, self.ep)
            stats.append(st)
        return y, stats

    def forward(self, x_mb: torch.Tensor, leaves: list, keep: bool):
        """The ticks: (out (M, b, T, D), zeros but on the last stage; the
        stage's statistics summed over its microbatches, flat; per
        microbatch (input, output, statistics) when ``keep``)."""
        S, s, M = self.S, self.s, self.M
        if keep:
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        blocks = _rebuild(self.template, leaves)
        out = torch.zeros_like(x_mb)
        acc = [torch.zeros((self.config.moe_experts,) if k in ("fsum", "psum") else (),
                           device=x_mb.device)
               for _ in blocks for k in _STATS] if self.moe else []
        act, saved = torch.zeros_like(x_mb[0]), {}
        for t in range(M + S - 1):
            m = t - s
            y_send = torch.zeros_like(act)
            if 0 <= m < M:
                inp = x_mb[m] if s == 0 else act
                if keep:
                    inp = inp.detach().requires_grad_()
                with torch.enable_grad() if keep else nullcontext():
                    y, stats = self._stage(blocks, inp, m)
                flat = [st[k] for st in stats for k in _STATS] if self.moe else []
                acc = [a + v.detach() for a, v in zip(acc, flat)]
                if keep:
                    saved[m] = (inp, y, flat)
                y_send = y.detach()
                if s == S - 1:
                    out[m] = y_send
            if S > 1 and t < M + S - 2:
                act = ring_shift(y_send, self.group)
        return out, acc, (leaves, saved)

    def backward(self, kept, g_out: torch.Tensor, g_stats: list):
        """The ticks in reverse: (the input's gradient on stage 0, else
        None; the stage leaves' gradients summed over the microbatches)."""
        S, s, M = self.S, self.s, self.M
        leaves, saved = kept
        g_leaves: list = [None] * len(leaves)
        g_x = torch.zeros_like(g_out) if s == 0 else None
        g_next = torch.zeros_like(g_out[0])  # the cotangent of the next tick's input
        for t in reversed(range(M + S - 1)):
            m = t - s
            g_y = (ring_shift(g_next, self.group, -1) if S > 1 and t < M + S - 2
                   else torch.zeros_like(g_next))
            g_next = torch.zeros_like(g_next)
            if not 0 <= m < M:
                continue
            inp, y, flat = saved.pop(m)
            if s == S - 1:
                g_y = g_y + g_out[m]
            outs, grads = [y], [g_y]
            for v, g in zip(flat, g_stats):
                if v.requires_grad and g is not None:
                    outs.append(v)
                    grads.append(g)
            got = torch.autograd.grad(outs, [inp, *leaves], grads, allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    g_leaves[i] = g if g_leaves[i] is None else g_leaves[i] + g
            if s == 0:
                g_x[m] = got[0]
            else:
                g_next = got[0]
        return g_x, g_leaves


class _RingFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x_mb, *leaves):
        out, acc, ctx.kept = ring.forward(x_mb, list(leaves), keep=True)
        ctx.ring = ring
        return (out, *acc)

    @staticmethod
    def backward(ctx, g_out, *g_stats):
        g_x, g_leaves = ctx.ring.backward(ctx.kept, g_out, list(g_stats))
        del ctx.kept
        return (None, g_x, *g_leaves)


def run_ring(blocks: list, config, x: torch.Tensor, lengths: torch.Tensor, mesh, axis: str,
             M: int, cd, offset: int = 0, valid=None, stats_start=None, ep_axis=None):
    """The ring over ``mesh``'s ``axis`` with this rank's stage ``blocks``
    on ``x`` (B, T, D), the rows this rank encodes (already projected):
    returns (out (B, T, D) on every rank of the axis, the stage's per-block
    router statistics summed over its microbatches, or None without MoE).
    ``offset``, ``valid``, ``stats_start``: the window's positions, as
    :func:`models.conformer.apply_block` takes them."""
    B, T, D = x.shape
    group = mesh.group(axis)
    ring = _Ring(blocks, config, lengths, group, mesh.shape[axis], mesh.coord(axis), M, cd,
                 offset, valid, stats_start, mesh.group(ep_axis) if ep_axis else None)
    leaves = tree_leaves(blocks)
    x_mb = x.reshape(M, B // M, T, D)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        out, *acc = _RingFunction.apply(ring, x_mb, *leaves)
    else:
        out, acc, _ = ring.forward(x_mb, leaves, keep=False)
    out = all_reduce_sum(out, group).reshape(B, T, D)
    if not config.moe_experts:
        return out, None
    n = len(_STATS)
    stats = [dict(zip(_STATS, acc[i:i + n])) for i in range(0, len(acc), n)]
    return out, stats


def ring_aux(config, stats: list, mesh, axis: str, token_axes: tuple[str, ...]) -> torch.Tensor:
    """The weighted router aux loss of the whole stack: each block's
    statistics summed over the axes that split its tokens
    (``token_axes``), its loss on this stage, the stages' sum over
    ``axis``, divided by the blocks."""
    from ..models.moe import aux_from_stats

    group = mesh.group(*(a for a in token_axes if mesh.shape.get(a, 1) > 1))
    stats = all_reduce_tree(stats, group)
    partial = sum(aux_from_stats(config, st) for st in stats)
    return all_reduce_sum(partial, mesh.group(axis)) / config.num_blocks


def _stage_blocks(params: dict, stacked_params, config, S: int, s: int) -> list:
    """This rank's stage: the rows of ``stacked_params`` (this stage's part
    of :func:`stack_block_params`, leading dim blocks-per-stage) or of
    ``params['blocks']``, which holds either the whole stack or the stage's
    blocks only (a placement of :func:`shard_stages`)."""
    if config.num_blocks % S:
        raise ValueError(f"{config.num_blocks} blocks do not split into {S} stages")
    per = config.num_blocks // S
    if stacked_params is not None:
        return [tree_map(lambda a, j=j: a[j], stacked_params) for j in range(per)]
    blocks = params["blocks"]
    if len(blocks) == config.num_blocks:
        return blocks[s * per:(s + 1) * per]
    if len(blocks) != per:
        raise ValueError(f"{len(blocks)} blocks: neither the stack of {config.num_blocks} "
                         f"nor one stage of {per}")
    return blocks


def _check_axes(config, ep_axis) -> None:
    if ep_axis is not None and not config.moe_experts:
        raise ValueError("ep_axis requires a MoE conformer (moe_experts)")


def pipeline_conformer_encode(
    params: dict,
    config,
    xs: torch.Tensor,  # (B, T, in_dim): already downsampled features
    mesh,
    axis: str = "pp",
    microbatches: int | None = None,
    lengths: torch.Tensor | None = None,
    compute_dtype=torch.float32,
    stacked_params=None,
    return_aux: bool = False,
    ep_axis: str | None = None,
):
    """Encode with the block stack pipelined over ``mesh``'s ``axis``.

    ``xs`` holds the rows this rank encodes (under a ``data`` axis its
    slice of the global batch); ``microbatches`` defaults to the stage
    count and must divide them.  Returns the (B, T, D) encoder output on
    every rank of the axis (the unsharded ``conformer_encode``'s values),
    and with ``return_aux`` the MoE conformer's weighted router aux loss
    (the statistics summed over ``data`` when the mesh has that axis).
    ``params`` is the conformer tree, with the whole stack of blocks or this
    rank's stage only; ``stacked_params`` (this stage's part of
    :func:`stack_block_params`) stands in for the blocks.  ``ep_axis``: the
    MoE experts split over that axis inside every stage.  JAX's ``tp_axis``
    has no counterpart: under tensor parallelism the caller gathers the
    split columns first, and the blocks come in whole."""
    from ..models.conformer import in_projection

    _check_axes(config, ep_axis)
    S = mesh.shape[axis]
    M = microbatches or S
    B, T, _ = xs.shape
    check_microbatches(B, M)
    blocks = _stage_blocks(params, stacked_params, config, S, mesh.coord(axis))
    cd = compute_dtype
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.long, device=xs.device)
    x = in_projection(params, xs, cd)
    out, stats = run_ring(blocks, config, x, lengths, mesh, axis, M, cd, ep_axis=ep_axis)
    if not return_aux:
        return out
    if stats is None:
        return out, torch.zeros((), device=out.device)
    return out, ring_aux(config, stats, mesh, axis, ("data",))
