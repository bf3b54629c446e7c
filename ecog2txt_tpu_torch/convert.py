"""Parameter trees across packages, and the port's checkpoints.

A parameter tree is the JAX package's ``init_seq2seq`` layout: nested
dicts and lists whose leaves are arrays.  ``params_from_numpy`` takes
that tree with numpy leaves (e.g. ``jax.tree.map(np.asarray, params)``)
and returns the same tree of torch tensors; ``params_to_numpy`` is its
inverse.  Checkpoints are ``torch.save`` files of such trees.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .quantize import QuantizedWeight, _column_major


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples
    (tuples come back as lists, as in the parameter trees; a NamedTuple
    such as ``quantize.QuantizedWeight`` keeps its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in the order
    ``tree_map`` visits them (dict keys in insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree, device="cuda"):
    """Numpy-leaf parameter tree → torch tensors on ``device``.  A
    NamedTuple leaf pair ``(q, scale)`` (the JAX package's int8
    ``QuantizedWeight``) becomes the port's ``quantize.QuantizedWeight``."""
    dev = resolve_device(device)
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == ("q", "scale"):
        q, scale = (params_from_numpy(a, dev) for a in tree)
        return QuantizedWeight(q=_column_major(q), scale=scale)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree)).to(dev)


def params_to_numpy(tree):
    """Torch parameter tree → numpy leaves (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def save_checkpoint(path: str, params, ema=None, epoch: int = 0) -> str:
    """Write ``{"params", "ema", "epoch"}`` (``ema`` defaults to
    ``params``) with ``torch.save``; tensors are stored on the host."""
    to_host = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    state = {
        "params": to_host(params),
        "ema": to_host(ema if ema is not None else params),
        "epoch": int(epoch),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(state, path)
    return path


def load_checkpoint(path: str, device="cuda") -> dict:
    """Read a :func:`save_checkpoint` file; tensors land on ``device``."""
    dev = resolve_device(device)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {
        "params": tree_map(lambda t: t.to(dev), state["params"]),
        "ema": tree_map(lambda t: t.to(dev), state["ema"]),
        "epoch": int(state["epoch"]),
    }
