"""The multi-process bootstrap.

The JAX package wires its processes together with
``jax.distributed.initialize`` and then drives one global mesh.  The port
runs one process a device, wired by ``torch.distributed``:

* :func:`initialize_distributed` wraps ``init_process_group`` over TCP.
  The backend is chosen before it starts: NCCL when the ranks run on
  CUDA and each can take a card of its own, gloo for ranks on the CPU or
  where this host is known to hold more ranks than cards, unless the
  caller names one.  A ``timeout`` bounds every collective, so that a
  lost peer fails the run instead of hanging it.  ``MultiSubjectTrainer`` calls it for
  ``SN_kwargs['distributed'] = {'coordinator_address': 'host:port',
  'num_processes': N, 'process_id': i}`` (optionally ``'local_world_size'``,
  ``'backend'``, ``'timeout'``), and from the environment that
  ``torchrun`` sets;
* :func:`make_global` is JAX's "global array from host copies": every
  process holds the same full host copy of each leaf (the same seed, the
  same data), and keeps the shard of it that a spec function gives it.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable

import torch
import torch.distributed as dist


def default_backend(device: str | torch.device | None = None,
                    local_world_size: int | None = None) -> str:
    """NCCL when the ranks run on CUDA and each can take a card of its own;
    gloo for ranks on the CPU, or where this host is known to hold more
    ranks than cards: ``local_world_size`` (else ``LOCAL_WORLD_SIZE``)
    above the host's cards, or a ``LOCAL_RANK`` beyond them.  Where the
    host's share of the world is not known (a multi-host world started by
    hand), each rank is taken to have a card: ranks that share one ask for
    ``backend='gloo'``."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    local = local_world_size or os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return "nccl" if int(local) <= cards else "gloo"
    if "LOCAL_RANK" in os.environ:
        return "nccl" if int(os.environ["LOCAL_RANK"]) < cards else "gloo"
    return "nccl"


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str | None = None,
    timeout: float = 600.0,
    device: str | torch.device | None = None,
    local_world_size: int | None = None,
) -> str:
    """``init_process_group`` over ``tcp://coordinator_address`` for rank
    ``process_id`` of ``num_processes``; returns the backend.  A second
    call in an initialised process returns the backend in use.  ``device``
    (the ranks' device type), ``local_world_size`` (the ranks on this
    host, where known) and the host's cards pick the backend when
    ``backend`` is None (:func:`default_backend`); ``timeout`` (seconds)
    bounds each collective."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or default_backend(device, local_world_size)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout),
    )
    if backend == "nccl":
        # NCCL's own collectives (barrier, objects) run on the current card
        torch.cuda.set_device(rank_device("cuda"))
    return backend


def initialize_from_environment(device=None, timeout: float = 600.0) -> str | None:
    """:func:`initialize_distributed` from the variables ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); None when
    they are absent."""
    if dist.is_initialized():
        return dist.get_backend()
    need = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    if not all(k in os.environ for k in need):
        return None
    return initialize_distributed(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        None, timeout, device,
    )


def rank_device(device: str | torch.device) -> torch.device:
    """The device of this rank: ``'cuda'`` without an index becomes the
    card ``LOCAL_RANK`` modulo the host's cards (several ranks may share
    one); anything else is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return dev


def map_with_path(fn: Callable, tree: Any, path=()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` is the
    tuple of dict keys and list indices from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def shard_of(leaf: torch.Tensor, mesh, axis: str | None) -> torch.Tensor:
    """This rank's block of ``leaf``'s dim 0 over mesh ``axis`` (the whole
    leaf for None)."""
    if axis is None:
        return leaf
    n, c = mesh.shape[axis], mesh.coord(axis)
    b = leaf.shape[0] // n
    return leaf[c * b:(c + 1) * b].clone()


def make_global(tree: Any, mesh, spec=None, spec_fn: Callable | None = None) -> Any:
    """This rank's shard of each leaf of a host-identical tree: ``spec``
    (one mesh axis name, or None for replicated) for every leaf, or
    ``spec_fn(path, leaf) -> axis or None`` per leaf (e.g.
    ``parallel.expert.ep_spec``).  A sharded leaf keeps the block of its
    dim 0 at this rank's coordinate on the axis."""
    return map_with_path(
        lambda path, leaf: shard_of(leaf, mesh, spec_fn(path, leaf) if spec_fn else spec),
        tree,
    )
