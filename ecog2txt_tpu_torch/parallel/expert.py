"""Expert parallelism: shard the MoE conformer's expert axis.

The MoE FFN (``models/moe.py``) stacks its expert weights on dim 0:
``w1 (E, D, F)``, ``b1 (E, F)``, ``w2 (E, F, D)``, ``b2 (E, D)``.  Over a
mesh axis of K ranks, rank k keeps experts ``[k·E/K, (k+1)·E/K)`` of each
such leaf, in the parameters, the EMA and (since the optimizer is built
over the held leaves) the Adam moments; the router (``wg``) and every
other leaf stay replicated.  Tokens stay replicated over the axis: each
rank runs its experts on every token, and the combine's partial outputs
are summed over the axis (``models/moe.py``, ``ep_axis``).

The rule is by path (a leaf is expert-stacked iff it sits under a MoE
``ffn2`` with one of those key names and a leading dim of E), so the same
function places a parameter tree or an EMA tree; :func:`gather_params_ep`
is its inverse, which a checkpoint under ep goes through so that it is
written in the one-process format.
"""

from __future__ import annotations

from typing import Any

import torch

from .comm import all_gather
from .multihost import make_global, map_with_path

# expert-stacked leaves of a MoE ffn2 (models/moe.py::init_moe_ffn)
_EP_KEYS = {"w1", "b1", "w2", "b2"}


def _is_expert_leaf(path: tuple, leaf: Any, n_experts: int) -> bool:
    keys = [k for k in path if isinstance(k, str)]
    return (
        "ffn2" in keys
        and keys[-1] in _EP_KEYS
        and hasattr(leaf, "ndim")
        and leaf.ndim >= 1
        and leaf.shape[0] == n_experts
    )


def ep_spec(path: tuple, leaf: Any, n_experts: int, axis: str) -> str | None:
    """The mesh axis one leaf is sharded over: ``axis`` for an expert
    leaf, None (replicated) for the others."""
    return axis if _is_expert_leaf(path, leaf, n_experts) else None


def expert_mask(tree: Any, n_experts: int) -> Any:
    """A tree of bools of ``tree``'s structure: which leaves are
    expert-stacked (the full, unsharded tree)."""
    return map_with_path(lambda path, leaf: _is_expert_leaf(path, leaf, n_experts), tree)


def _check_divides(mesh, n_experts: int, axis: str) -> None:
    if n_experts % mesh.shape[axis]:
        raise ValueError(
            f"moe_experts={n_experts} must divide evenly over mesh axis {axis!r} "
            f"of size {mesh.shape[axis]}"
        )


def shard_params_ep(tree: Any, mesh, n_experts: int, axis: str = "model") -> Any:
    """This rank's placement of a parameter-shaped tree (parameters, EMA)
    under expert parallelism: expert leaves cut to this rank's block of
    experts on ``axis``, every other leaf kept whole."""
    _check_divides(mesh, n_experts, axis)
    return make_global(
        tree, mesh, spec_fn=lambda path, leaf: ep_spec(path, leaf, n_experts, axis)
    )


def gather_params_ep(tree: Any, mesh, n_experts: int, axis: str = "model") -> Any:
    """The full tree from each rank's :func:`shard_params_ep` placement:
    the expert leaves gathered over ``axis`` (every rank of the axis takes
    part and gets the whole tree)."""
    _check_divides(mesh, n_experts, axis)
    local = n_experts // mesh.shape[axis]
    group = mesh.group(axis)

    def one(path, leaf):
        if _is_expert_leaf(path, leaf, local):
            with torch.no_grad():
                return all_gather(leaf.detach().contiguous(), group, 0)
        return leaf

    return map_with_path(one, tree)
