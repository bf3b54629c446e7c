"""The mesh: ranks laid out on named axes, one process group an axis.

The JAX package drives an SPMD mesh of devices from one controller
(``ecog2txt_tpu/parallel/mesh.py``).  The port runs one process a device,
so its mesh is the world's ranks laid out as ``(data, model[, seq])``:
rank r sits where device r sits in JAX's ``np.reshape`` of the device
list, and every line along an axis (and along each set of axes) is a
``torch.distributed`` process group.  On that mesh:

* **data parallelism**: each rank takes its slice of the batch's leading
  axis (:func:`batch_sharding`), the loss is the global batch's (each
  rank's sums over the global token counts, ``models/seq2seq.py``), and
  the gradients are summed over the ranks (:func:`reduce_gradients_`);
* the ``model`` axis carries expert parallelism (``parallel/expert.py``)
  and the ``seq`` axis the conformer's time axis
  (``parallel/sequence.py``).

Tensor parallelism (``_tp_spec``, ``shard_params_tp``) is not ported yet
(see ROADMAP.md, Queue 1, item 10b).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..convert import tree_leaves, tree_map
from .comm import all_reduce_grads_, all_reduce_sum, broadcast_
from .expert import expert_mask


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
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._groups[frozenset(axes)] = self._make_groups(axes)

    def _make_groups(self, axes: tuple[str, ...]):
        """Every line of the mesh along ``axes`` becomes a group (each rank
        creates all of them, in the same order); returns this rank's."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        moved = np.transpose(self.devices, rest + keep).reshape(
            -1, int(np.prod([self.devices.shape[i] for i in keep]))
        )
        mine = None
        for line in moved:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks=ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def group(self, *axes: str):
        """The process group of this rank's line along ``axes``."""
        return self._groups[frozenset(axes)]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def mesh_layout(n_data: int, n_model: int = 1, n_seq: int = 1) -> np.ndarray:
    """The ranks of a ``(data, model[, seq])`` mesh: ``arange`` reshaped, as
    JAX's ``make_mesh`` reshapes its device list."""
    if n_seq > 1:
        return np.arange(n_data * n_model * n_seq).reshape(n_data, n_model, n_seq)
    return np.arange(n_data * n_model).reshape(n_data, n_model)


def make_mesh(n_data: int | None = None, n_model: int = 1, n_seq: int = 1) -> Mesh:
    """``(data, model[, seq])`` mesh over the world's ranks (the
    ``seq`` axis only when ``n_seq`` > 1).  ``n_data`` defaults to the
    world size over ``n_model · n_seq``; the mesh must cover the world
    (a rank outside it would have no part in the collectives)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs torch.distributed: call "
            "parallel.initialize_distributed (or run under torchrun) first"
        )
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_model * n_seq)
    if n_data * n_model * n_seq != world:
        raise ValueError(
            f"a (data={n_data}, model={n_model}, seq={n_seq}) mesh needs "
            f"{n_data * n_model * n_seq} ranks; the world has {world}"
        )
    names = ("data", "model", "seq") if n_seq > 1 else ("data", "model")
    return Mesh(names, mesh_layout(n_data, n_model, n_seq), dist.get_rank())


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


def reduce_gradients_(grads: list[torch.Tensor], mesh: Mesh | None,
                      sharded: list[bool] | None = None) -> None:
    """Sum the gradients in place over the ranks that hold each leaf: a
    replicated leaf over the whole mesh, an expert leaf (``sharded``) over
    its ``data`` and ``seq`` lines only (the ``model`` ranks hold other
    experts).  With each rank's loss its share of the global loss, the
    sums are the single-device gradients."""
    if mesh is None:
        return
    sharded = sharded or [False] * len(grads)
    every = [g for g, s in zip(grads, sharded) if not s]
    experts = [g for g, s in zip(grads, sharded) if s]
    for bucket, group in ((every, mesh.group(*mesh.axis_names)),
                          (experts, mesh.group(*(a for a in mesh.axis_names if a != "model")))):
        by_dtype: dict = {}
        for g in bucket:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            all_reduce_grads_(same, group)


def global_norm(grads: list[torch.Tensor], mesh: Mesh | None = None,
                sharded: list[bool] | None = None) -> torch.Tensor:
    """The norm over every leaf of the global gradient: a replicated leaf
    counts once, the expert leaves' squares are summed over the ``model``
    axis (each rank holds its experts' share)."""
    def norm(gs):
        if not gs:
            return torch.zeros((), device=grads[0].device)
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in gs])
        )

    if mesh is None or not sharded or not any(sharded):
        return norm(grads)
    every = [g for g, s in zip(grads, sharded) if not s]
    experts = [g for g, s in zip(grads, sharded) if s]
    with torch.no_grad():
        return torch.sqrt(norm(every) ** 2 + all_reduce_sum(norm(experts) ** 2, mesh.group("model")))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        mesh: Mesh | None = None, sharded: list[bool] | None = None) -> None:
    """optax.clip_by_global_norm in place: ``g * max_norm / max(|g|,
    max_norm)``, |g| the global norm (:func:`global_norm`; no host sync)."""
    norm = global_norm(grads, mesh, sharded)
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


def make_dp_train_step(loss_fn, ema_decay: float, mesh: Mesh | None = None,
                       clip_norm: float | None = None, local_experts: int = 0):
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
    ranks that hold each leaf (:func:`reduce_gradients_`; under expert
    parallelism ``local_experts`` is the experts a rank holds, whose leaves
    are summed over their ``data`` and ``seq`` lines only), clips them by
    their global norm when ``clip_norm`` is given (optax's
    ``clip_by_global_norm`` chained before the optimizer), takes the
    ``optimizer``'s step (``train.make_optimizer``: Adam over ``params``'
    leaves) and updates the EMA, all in place.  Returns ``step(params, ema,
    optimizer, batch, generator) -> (loss, metrics)``, the loss summed over
    the mesh; the summed, clipped gradients stay on the leaves' ``grad``."""
    shard = batch_sharding(mesh) if mesh is not None else (lambda tree: tree)
    sharded = None

    def step(params, ema, optimizer, batch, generator=None):
        nonlocal sharded
        local = shard({k: v for k, v in batch.items() if k != "subject_idx"})
        if "subject_idx" in batch:
            local["subject_idx"] = batch["subject_idx"]
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(params, local, generator)
        loss.backward()
        leaves = tree_leaves(params)
        if sharded is None and local_experts:
            sharded = tree_leaves(expert_mask(params, local_experts))
        grads = [p.grad for p in leaves]
        reduce_gradients_(grads, mesh, sharded)
        if clip_norm is not None:
            clip_by_global_norm(grads, clip_norm, mesh, sharded)
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
