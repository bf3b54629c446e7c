"""The mesh: ranks laid out on named axes, one process group an axis.

The JAX package drives an SPMD mesh of devices from one controller
(``ecog2txt_tpu/parallel/mesh.py``).  The port runs one process a device,
so its mesh is the world's ranks laid out as ``(data, model[, seq])``, or
with a pipeline as ``(data[, seq], pp[, model])`` (the JAX trainer's
meshes): rank r sits where device r sits in JAX's ``np.reshape`` of the
device list, and every line along an axis (and along each set of axes) is
a ``torch.distributed`` process group.  On that mesh:

* **data parallelism**: each rank takes its slice of the batch's leading
  axis (:func:`batch_sharding`), the loss is the global batch's (each
  rank's sums over the global token counts, ``models/seq2seq.py``), and
  the gradients are summed over the ranks (:func:`reduce_gradients_`);
* **tensor parallelism** on the ``model`` axis (:func:`shard_params_tp`,
  JAX's ``_tp_spec`` rule): a leaf of 2 or more dims whose last dim
  divides by K and is at least 4·K keeps this rank's block of columns (the
  subsample conv stays replicated), and so do its EMA and Adam moments.
  The loss gathers the blocks to the whole leaf on entry
  (:func:`gather_params_tp`, ``models/seq2seq.py``) and every rank runs the
  unsharded function on them: only parameter-sized tensors cross ranks,
  and the model code knows nothing of tp.  The gather's adjoint gives
  each rank its block of the gradient summed over the axis;
* the ``model`` axis carries expert parallelism instead where it is asked
  for (``parallel/expert.py``), the ``seq`` axis the conformer's time axis
  (``parallel/sequence.py``) and the ``pp`` axis the conformer's block
  stack (``parallel/pipeline.py``).

A leaf is *split* over the axes whose ranks hold different parts of it
(``model`` for a tp or expert shard, ``pp`` for a pipeline stage's block)
and replicated over the others: its gradient is summed over the axes it is
not split over, and its squares over the axes it is split over, so that
each weight counts once in the global norm.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..convert import tree_leaves, tree_map
from .comm import all_gather, all_reduce_grads_, all_reduce_sum, broadcast_
from .expert import expert_mask, gather_params_ep, shard_params_ep
from .multihost import map_with_path
from .pipeline import gather_stages, shard_stages, stage_mask


class Mesh:
    """The world's ranks on named axes: ``devices`` is the array of ranks
    (one dim an axis of ``axis_names``), ``shape`` maps each axis to its
    size, ``coords`` is this rank's position, and :meth:`group` the process
    group of this rank's line along one axis or a set of axes (created for
    every set, by every rank, when the mesh is made)."""

    def __init__(self, axis_names: tuple[str, ...], devices: np.ndarray, rank: int):
        self.axis_names = tuple(axis_names)
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.rank = rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not on a mesh of {self.size} ranks")
        self.coords = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self._groups: dict[frozenset, Any] = {}
        by_lines: dict[tuple, Any] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[frozenset(axes)] = self._make_groups(axes, by_lines)

    def _make_groups(self, axes: tuple[str, ...], by_lines: dict):
        """Every line of the mesh along ``axes`` becomes a group (each rank
        creates all of them, in the same order; sets of axes with the same
        lines, as where an axis has one rank, share their groups); returns
        this rank's."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        moved = np.transpose(self.devices, rest + keep).reshape(
            -1, int(np.prod([self.devices.shape[i] for i in keep]))
        )
        lines = tuple(sorted(tuple(sorted(int(r) for r in line)) for line in moved))
        if lines not in by_lines:
            by_lines[lines] = [(ranks, dist.new_group(ranks=list(ranks))) for ranks in lines]
        return next(group for ranks, group in by_lines[lines] if self.rank in ranks)

    def group(self, *axes: str):
        """The process group of this rank's line along ``axes`` (None, a
        group of this rank alone, for no axis)."""
        return self._groups[frozenset(axes)] if axes else None

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def mesh_axes(n_model: int = 1, n_seq: int = 1, n_pp: int = 1) -> tuple[str, ...]:
    """The axis names of the JAX trainer's mesh for these sizes:
    ``(data, model[, seq])``, or with a pipeline ``(data[, seq], pp[,
    model])`` (``ecog2txt_tpu/train.py``'s pipeline branch)."""
    if n_pp > 1:
        return ("data", *(("seq",) if n_seq > 1 else ()), "pp",
                *(("model",) if n_model > 1 else ()))
    return ("data", "model", "seq") if n_seq > 1 else ("data", "model")


def mesh_layout(n_data: int, n_model: int = 1, n_seq: int = 1, n_pp: int = 1) -> np.ndarray:
    """The ranks of the mesh of :func:`mesh_axes`: ``arange`` reshaped, as
    JAX reshapes its device list."""
    size = {"data": n_data, "model": n_model, "seq": n_seq, "pp": n_pp}
    shape = [size[a] for a in mesh_axes(n_model, n_seq, n_pp)]
    return np.arange(int(np.prod(shape))).reshape(shape)


def make_mesh(n_data: int | None = None, n_model: int = 1, n_seq: int = 1,
              n_pp: int = 1) -> Mesh:
    """The mesh of :func:`mesh_axes` over the world's ranks.  ``n_data``
    defaults to the world size over the other axes; the mesh must cover
    the world (a rank outside it would have no part in the collectives)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed: call "
            "parallel.initialize_distributed (or run under torchrun) first"
        )
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_seq * n_pp)
    if n_data * n_model * n_seq * n_pp != world:
        raise ValueError(
            f"a (data={n_data}, model={n_model}, seq={n_seq}, pp={n_pp}) mesh needs "
            f"{n_data * n_model * n_seq * n_pp} ranks; the world has {world}"
        )
    return Mesh(mesh_axes(n_model, n_seq, n_pp), mesh_layout(n_data, n_model, n_seq, n_pp),
                dist.get_rank())


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every leaf broadcast in place from the mesh's first rank (the same
    values on every rank); returns the tree."""
    broadcast_([t for t in tree_leaves(tree) if torch.is_tensor(t)],
               mesh.group(*mesh.axis_names))
    return tree


def batch_sharding(mesh: Mesh) -> Callable[[Any], Any]:
    """``shard(tree)``: this rank's slice of each leaf's leading (batch)
    axis over the ``data`` axis.  A leaf whose leading dim does not divide
    by the axis (or a scalar) stays whole, as JAX's constraint leaves it
    unsplit."""
    n, c = mesh.shape["data"], mesh.coord("data")

    def shard(tree):
        def one(leaf):
            if torch.is_tensor(leaf) and leaf.dim() >= 1 and leaf.shape[0] % n == 0:
                b = leaf.shape[0] // n
                return leaf[c * b:(c + 1) * b]
            return leaf

        return tree_map(one, tree)

    return shard


def _tp_spec(path: tuple, leaf: Any, n_model: int) -> str | None:
    """JAX's tensor-parallel rule for one parameter leaf: ``'model'`` (its
    last dim split over the axis) for a leaf of 2 or more dims whose last
    dim divides by ``n_model`` and is at least 4·``n_model``, else None
    (replicated).  The subsample conv stack (``subnet``/``conv``) stays
    replicated, as JAX keeps it; the conformer conv module's pointwise
    kernels (``blocks[i]['conv']``) do not sit under ``subnet`` and are
    sharded."""
    if n_model <= 1 or not hasattr(leaf, "dim") or leaf.dim() < 2:
        return None
    keys = {k for k in path if isinstance(k, str)}
    if "subnet" in keys and "conv" in keys:
        return None
    if leaf.shape[-1] % n_model == 0 and leaf.shape[-1] >= 4 * n_model:
        return "model"
    return None


def tp_mask(tree: Any, n_model: int) -> Any:
    """A tree of bools of the whole ``tree``'s structure: which leaves
    tensor parallelism over ``n_model`` ranks splits (:func:`_tp_spec`)."""
    return map_with_path(lambda path, leaf: _tp_spec(path, leaf, n_model) is not None, tree)


def shard_params_tp(tree: Any, mesh: Mesh, axis: str = "model") -> Any:
    """This rank's placement of a whole parameter-shaped tree (parameters,
    EMA) under tensor parallelism: each leaf of :func:`tp_mask` cut to this
    rank's block of columns on ``axis``, every other leaf kept whole.  The
    optimizer is built over the held leaves, so the Adam moments are the
    blocks' too."""
    n, c = mesh.shape[axis], mesh.coord(axis)

    def one(path, leaf):
        if _tp_spec(path, leaf, n) is None:
            return leaf
        w = leaf.shape[-1] // n
        return leaf.detach()[..., c * w:(c + 1) * w].clone()

    return map_with_path(one, tree)


def gather_params_tp(tree: Any, mesh: Mesh, mask: Any, axis: str = "model") -> Any:
    """The inverse of :func:`shard_params_tp`: the leaves ``mask`` marks
    (:func:`tp_mask`, cut as ``tree`` is) gathered over ``axis`` in rank
    order (every rank of the axis takes part and gets the whole leaves).
    Differentiable: the adjoint is this rank's block of the cotangent summed
    over the axis, so with each rank's loss its share, the gradient of a
    split leaf is its block of the one-process gradient."""
    group = mesh.group(axis)
    marks = iter(tree_leaves(mask))
    return tree_map(lambda leaf: all_gather(leaf, group, -1) if next(marks) else leaf, tree)


def parallel_modes(mesh: Mesh, split_by: str | None = None, microbatches: int | None = None,
                   tp_mask: Any = None) -> dict:
    """``seq2seq_loss``'s parallel keywords on ``mesh`` (the JAX trainer's
    ``sp`` / ``pp`` arguments and the port's ``dp`` / ``ep`` / ``tp``):
    ``dp=(mesh, 'data')`` where that axis has more than one rank,
    ``sp=(mesh, 'seq')`` and ``pp=(mesh, 'pp', microbatches)`` (default:
    the stages) where the mesh has those axes, and what the ``model`` axis
    splits, ``split_by``: ``ep=(mesh, 'model')`` or ``tp=(mesh, 'model',
    tp_mask)``, ``tp_mask`` marking the column-split leaves of this rank's
    tree (:meth:`Placement.modes` passes it)."""
    modes: dict = {}
    if mesh.shape["data"] > 1:
        modes["dp"] = (mesh, "data")
    if "seq" in mesh.shape:
        modes["sp"] = (mesh, "seq")
    if "pp" in mesh.shape:
        modes["pp"] = (mesh, "pp", microbatches or mesh.shape["pp"])
    if split_by == "ep":
        modes["ep"] = (mesh, "model")
    elif split_by == "tp":
        if tp_mask is None:
            raise ValueError("tensor parallelism needs the mask of the column-split leaves")
        modes["tp"] = (mesh, "model", tp_mask)
    elif split_by is not None:
        raise ValueError(f"the model axis splits by 'tp' or 'ep', not {split_by!r}")
    return modes


class Placement:
    """Where each leaf of a parameter tree lives on ``mesh``: under tensor
    parallelism (``tp``) the columns of the leaves :func:`tp_mask` marks on
    the ``model`` axis, under expert parallelism (``experts``: the MoE's E)
    the experts on ``model``, under pipeline parallelism (``pp``) the
    conformer's blocks in stages on ``pp``.  Made from the whole tree (its
    shapes decide the tp leaves); :meth:`place` cuts any tree of that
    structure (parameters, EMA) to this rank's parts, :meth:`gather` is its
    inverse (a collective), :meth:`split` lists the axes each placed leaf is
    split over (``reduce_gradients_``, ``global_norm``), :meth:`modes` gives
    the loss's parallel keywords.  ``place`` reads only ``mesh.shape`` and
    ``mesh.coord``.  Tensor and expert parallelism both split weights over
    ``model``, so they exclude each other (``ValueError``, as JAX refuses)."""

    def __init__(self, mesh, tree: Any, tp: bool = False, experts: int = 0, pp: bool = False):
        if tp and experts:
            raise ValueError("tensor parallelism and expert parallelism are mutually "
                             "exclusive: both split weights over the 'model' axis")
        self.mesh, self.tp, self.experts, self.pp = mesh, tp, experts, pp
        self.tp_mask = tp_mask(tree, mesh.shape["model"]) if tp else None

    def modes(self, microbatches: int | None = None) -> dict:
        """``seq2seq_loss``'s parallel keywords for trees placed here
        (:func:`parallel_modes`)."""
        split_by = "tp" if self.tp else "ep" if self.experts else None
        mask = None
        if self.tp:
            mask = shard_stages(self.tp_mask, self.mesh) if self.pp else self.tp_mask
        return parallel_modes(self.mesh, split_by, microbatches, mask)

    def place(self, tree: Any) -> Any:
        if self.tp:
            tree = shard_params_tp(tree, self.mesh)
        if self.experts:
            tree = shard_params_ep(tree, self.mesh, self.experts)
        return shard_stages(tree, self.mesh) if self.pp else tree

    def gather(self, tree: Any) -> Any:
        if self.pp:
            tree = gather_stages(tree, self.mesh)
        if self.experts:
            tree = gather_params_ep(tree, self.mesh, self.experts)
        if not self.tp:
            return tree
        with torch.no_grad():
            return gather_params_tp(tree, self.mesh, self.tp_mask)

    def split(self, tree: Any) -> list[tuple[str, ...]]:
        model = tree_map(lambda _: False, tree)
        if self.tp:
            model = shard_stages(self.tp_mask, self.mesh) if self.pp else self.tp_mask
        if self.experts:
            model = expert_mask(tree, self.experts // self.mesh.shape["model"])
        stage = stage_mask(tree) if self.pp else tree_map(lambda _: False, tree)
        return [("pp",) * s + ("model",) * m
                for s, m in zip(tree_leaves(stage), tree_leaves(model))]


def _axes(split) -> tuple[str, ...]:
    """A leaf's split axes: a tuple of axis names; True (an expert leaf,
    as ``parallel.expert.expert_mask`` marks it) is ``('model',)``."""
    if split is True:
        return ("model",)
    return tuple(split or ())


def reduce_gradients_(grads: list[torch.Tensor], mesh: Mesh | None,
                      split: list | None = None) -> None:
    """Sum the gradients in place over the ranks that hold each leaf whole
    or the same part of it: each over the mesh axes its leaf is not
    ``split`` over (a replicated leaf over the whole mesh, a tp or expert
    shard over all but ``model``, a pipeline stage's block over all but
    ``pp``).  With each rank's loss its share of the global loss, the sums
    are the single-device gradients."""
    if mesh is None:
        return
    split = split or [()] * len(grads)
    buckets: dict = {}
    for g, s in zip(grads, split):
        buckets.setdefault((_axes(s), g.dtype), []).append(g)
    for (axes, _), same in buckets.items():
        all_reduce_grads_(same, mesh.group(*(a for a in mesh.axis_names if a not in axes)))


def global_norm(grads: list[torch.Tensor], mesh: Mesh | None = None,
                split: list | None = None) -> torch.Tensor:
    """The norm over every leaf of the global gradient (no host sync): the
    squares of a leaf's part are summed over the axes it is ``split`` over
    (each rank holds another part there) and counted once over the others
    (where the reduced gradients are the same)."""
    if not grads:
        return torch.zeros(())
    split = split or [()] * len(grads)
    squares: dict = {}
    for g, s in zip(grads, split):
        squares.setdefault(_axes(s), []).append(torch.linalg.vector_norm(g.float()) ** 2)
    with torch.no_grad():
        total = torch.zeros((), device=grads[0].device)
        for axes, sq in squares.items():
            part = torch.stack(sq).sum()
            total = total + (all_reduce_sum(part, mesh.group(*axes))
                             if mesh is not None and axes else part)
        return torch.sqrt(total)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        mesh: Mesh | None = None, split: list | None = None) -> None:
    """optax.clip_by_global_norm in place: ``g * max_norm / max(|g|,
    max_norm)``, |g| the global norm (:func:`global_norm`; no host sync)."""
    norm = global_norm(grads, mesh, split)
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


def make_dp_train_step(loss_fn, ema_decay: float, mesh: Mesh | None = None,
                       clip_norm: float | None = None, split: list | None = None):
    """One data-parallel training step, the counterpart of the JAX
    package's ``make_dp_train_step``; the trainer's segment runner takes
    its steps here too (``train.make_segment_runner``, ``mesh=None`` in one
    process).

    ``loss_fn(params, batch, generator) -> (loss, metrics)`` gets this
    rank's slice of the batch (:func:`batch_sharding`: the whole batch where
    its leading dim does not divide by the ``data`` axis) and returns its
    share of the global loss (``seq2seq_loss(..., dp=(mesh, 'data'))``
    divides by the token counts summed over the axis, so a whole batch on
    each of n ranks gives each 1/n of the loss): the shares sum to the
    loss over the global batch.  The step sums the gradients over the
    ranks that hold each leaf (:func:`reduce_gradients_`: ``split`` lists
    the axes each leaf of ``params`` is split over, :meth:`Placement.split`;
    a leaf that took no part in this rank's loss, as the
    encoder's input projection on a later pipeline stage, gets a zero
    gradient first, so that every rank's optimizer steps every leaf), clips them by
    their global norm when ``clip_norm`` is given (optax's
    ``clip_by_global_norm`` chained before the optimizer), takes the
    ``optimizer``'s step (``train.make_optimizer``: Adam over ``params``'
    leaves) and updates the EMA, all in place.  Returns ``step(params, ema,
    optimizer, batch, generator) -> (loss, metrics)``, the loss summed over
    the mesh; the summed, clipped gradients stay on the leaves' ``grad``."""
    shard = batch_sharding(mesh) if mesh is not None else (lambda tree: tree)

    def step(params, ema, optimizer, batch, generator=None):
        local = shard({k: v for k, v in batch.items() if k != "subject_idx"})
        if "subject_idx" in batch:
            local["subject_idx"] = batch["subject_idx"]
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, local, generator)
        loss.backward()
        leaves = tree_leaves(params)
        if mesh is not None:
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        reduce_gradients_(grads, mesh, split)
        if clip_norm is not None:
            clip_by_global_norm(grads, clip_norm, mesh, split)
        optimizer.step()
        with torch.no_grad():
            shadow = tree_leaves(ema)
            torch._foreach_mul_(shadow, ema_decay)
            torch._foreach_add_(shadow, leaves, alpha=1.0 - ema_decay)
        loss = loss.detach()
        if mesh is not None:
            loss = all_reduce_sum(loss, mesh.group(*mesh.axis_names))
        return loss, {k: v.detach() for k, v in metrics.items()}

    return step
