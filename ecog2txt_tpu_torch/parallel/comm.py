"""Collectives over ``torch.distributed`` process groups, with their adjoints.

The JAX package writes no collective: XLA inserts them from shardings
(``psum``, ``ppermute``, the gather of a time-sharded output).  The port
runs one process a device, so each one is written here as a
``torch.autograd.Function`` whose backward is the collective's adjoint:

* :func:`all_reduce_sum` — forward a sum over the group, backward a sum of
  the cotangents over the group (the adjoint of ``psum``);
* :func:`all_gather` — forward the group's pieces concatenated along a
  dim, backward the cotangent summed over the group and this rank's piece
  taken back out (a reduce-scatter); along the last dim it is tensor
  parallelism's column gather (``parallel/mesh.py::gather_params_tp``);
* :func:`ring_shift` — the pipeline ring's send/receive pair (JAX's
  ``ppermute`` to the next rank): each rank of the group sends its tensor
  to the rank ``step`` places on and receives from the rank ``step``
  places back (zeros where there is none); the adjoint is the shift back,
  so the gradient travels back along the ring.

With these adjoints, a loss that every rank of a group computes alike
(after a gather, or after the expert combine's sum) counts once when each
rank scales it by 1/n and the gradients are summed over the ranks.

Where the tensors live decides how a collective runs, before it runs:
NCCL takes CUDA tensors for all of them; gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only, so under gloo a CUDA tensor of the
other collectives here, the gathers and the ring's sends and receives, is
staged through host memory (:func:`stages_through_host`).  The ring posts
its send and its receive together (``isend`` / ``irecv``) before it waits
for either, so no two ranks block on each other.  Nothing is retried on another
path after a failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the collectives gloo runs on CUDA tensors itself; any other is staged
# through host memory
_GLOO_CUDA = ("all_reduce", "broadcast")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def stages_through_host(group, tensor: torch.Tensor, collective: str) -> bool:
    """Whether ``collective`` on ``tensor`` over ``group`` copies through
    host memory: a CUDA tensor under gloo, for the collectives gloo does
    not run on the card."""
    return (
        tensor.is_cuda
        and dist.get_backend(group) == "gloo"
        and collective not in _GLOO_CUDA
    )


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather_pieces(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    if stages_through_host(group, x, "all_gather"):
        host = x.cpu()
        pieces = [torch.empty_like(host) for _ in range(group_size(group))]
        dist.all_gather(pieces, host, group=group)
        return [p.to(x.device) for p in pieces]
    pieces = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(pieces, x, group=group)
    return pieces


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(_gather_pieces(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce_(g.contiguous().clone(), ctx.group)
        start = group_rank(ctx.group) * ctx.size
        return total.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (the identity for no group or one rank);
    its adjoint sums the cotangents over the group."""
    if group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_tree(tree: list, group) -> list:
    """:func:`all_reduce_sum` of every tensor of a list of dicts (None
    entries kept), in one collective over their concatenation."""
    if group_size(group) == 1:
        return tree
    flat = [(i, k, v) for i, d in enumerate(tree) if d is not None for k, v in d.items()]
    if not flat:
        return tree
    total = all_reduce_sum(torch.cat([v.reshape(-1).float() for _, _, v in flat]), group)
    out = [None if d is None else {} for d in tree]
    start = 0
    for i, k, v in flat:
        out[i][k] = total[start:start + v.numel()].reshape(v.shape)
        start += v.numel()
    return out


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (every
    rank's piece the same shape); its adjoint is a reduce-scatter."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the group rank ``step`` places on and receive the same
    shape from the rank ``step`` places back (zeros where there is none):
    one ``isend`` and one ``irecv`` posted together, then waited for."""
    n, r = group_size(group), group_rank(group)
    host = stages_through_host(group, x, "send")
    buf = x.detach().contiguous()
    buf = buf.cpu() if host else buf
    recv = torch.zeros_like(buf)
    works = []
    if 0 <= r + step < n:
        works.append(dist.isend(buf, dist.get_global_rank(group, r + step), group=group))
    if 0 <= r - step < n:
        works.append(dist.irecv(recv, dist.get_global_rank(group, r - step), group=group))
    for w in works:
        w.wait()
    return recv.to(x.device) if host else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` by ``step`` along the group's ranks, without wrap:
    every rank calls it with a tensor of the same shape; it returns what the
    rank ``step`` places back sent (zeros for the first ``step`` ranks); the
    adjoint shifts the cotangents back by ``step``."""
    if group_size(group) == 1:
        return torch.zeros_like(x)
    return _RingShift.apply(x, group, step)


def broadcast_(tensors: list[torch.Tensor], group, src_group_rank: int = 0) -> None:
    """Broadcast each tensor in place from the group's ``src_group_rank``."""
    if group_size(group) == 1:
        return
    src = dist.get_global_rank(group, src_group_rank)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


def all_reduce_grads_(tensors: list[torch.Tensor], group) -> None:
    """Sum the tensors over ``group`` in place, in one collective over a
    flat bucket of their values (a gradient all-reduce)."""
    if group_size(group) == 1 or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _all_reduce_(flat, group)
        start = 0
        for t in tensors:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()
