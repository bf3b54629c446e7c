"""Routed mixture-of-experts FFN for the conformer encoder.

The twin of ``ecog2txt_tpu/models/moe.py``: a top-k routed MoE FFN that
replaces the conformer's second macaron FFN (``moe_experts > 0``), with
the same parameter tree (``init_moe_ffn``: experts on dim 0, weights
stored (in, out)) and the same functions:

* the router: logits, softmax and the renormalised top-k gates in f32
  whatever the compute dtype (router decisions are control flow).  The
  top k are taken by k rounds of ``argmax`` with the chosen experts
  masked out, so ties go to the lower expert index, as ``jax.lax.top_k``
  orders them, on the CPU and on the card alike;
* the no-drop path (``moe_capacity_factor == 0``): every expert on every
  token, combined by the top-k gates.  Per token, so a
  :class:`models.conformer.ConformerStream` equals the offline encode;
* the capacity path (``moe_capacity_factor > 0``): per dispatch group
  ``C = ceil(topk * S / E * cf)`` slots an expert, filled by (choice
  rank, then time order) with a cumsum position per expert; overflow
  is dropped (the block's residual carries the token).  Groups are batch
  rows, or ``moe_group_size``-step segments of a row (T padded up to
  whole segments).  Where the JAX package builds one-hot (G, S, E, C)
  dispatch and combine tensors for its matrix units, this port gathers:
  the kept tokens are copied into a (G, E, C, D) buffer by index, the
  experts run on the buffer, and each kept choice reads its slot back.
  The kept (token, choice) pairs and their combine weights are the JAX
  package's exactly;
* the router statistics (additive sums over valid tokens) and the
  weighted Switch load-balance + router z-loss built from them.

Tokens outside the recording (positions below 0 or from ``length`` on)
take no capacity and do not count in the statistics.  The products take
both operands in the compute dtype (f32 accumulation inside).

Expert parallelism (``ep_axis``, a process group; ``parallel/expert.py``
places the weights): the expert-stacked leaves of ``p`` hold only this
rank's E/K experts, from ``k0 = rank · E/K``.  Tokens stay replicated
over the group, so the router, its choices and the capacity slots (taken
over all E experts) are every rank's alike; each rank runs its experts
and the partial combines are summed over the group
(``parallel.comm.all_reduce_sum``, whose adjoint sums the cotangents).
The routed function, drops included, is the unsharded one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.comm import all_reduce_sum, group_rank


def glorot(generator: torch.Generator, shape) -> torch.Tensor:
    """Glorot-uniform over the trailing (fan_in, fan_out) dims, shared with
    the conformer's init (``models/conformer.py`` imports it)."""
    scale = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * scale


def init_moe_ffn(generator: torch.Generator, D: int, Fd: int, E: int) -> dict:
    """Expert-stacked FFN parameters (experts on dim 0), on the CPU."""
    return {
        "wg": glorot(generator, (D, E)),
        "w1": glorot(generator, (E, D, Fd)),
        "b1": torch.zeros((E, Fd)),
        "w2": glorot(generator, (E, Fd, D)),
        "b2": torch.zeros((E, D)),
        "ln": {"g": torch.ones((D,)), "b": torch.zeros((D,))},
    }


def top_k_first(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries over the last axis,
    largest first and the lower index first among equal values (the
    order of ``jax.lax.top_k``): k rounds of ``argmax``, which returns
    the first maximum, with each chosen entry masked out after its round."""
    masked = probs.detach()
    idx = []
    for _ in range(k):
        i = torch.argmax(masked, dim=-1, keepdim=True)
        idx.append(i)
        masked = masked.scatter(-1, i, float("-inf"))
    gate_idx = torch.cat(idx, dim=-1)
    return torch.gather(probs, -1, gate_idx), gate_idx


def _route(p: dict, xn: torch.Tensor, topk: int):
    """The router on the LayerNormed input, in f32: (logits, probs, gates,
    gate_idx)."""
    logits = torch.matmul(xn.float(), p["wg"].float())
    probs = torch.softmax(logits, dim=-1)  # (..., E)
    gate_vals, gate_idx = top_k_first(probs, topk)  # (..., k)
    gates = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gates, gate_idx


def router_stats(logits, probs, gate_idx, valid: torch.Tensor) -> dict:
    """Sums over the valid tokens: the additive statistics of the aux
    loss (leading dims (B, T) or (G, S))."""
    E = probs.shape[-1]
    validf = valid.float()
    assign = F.one_hot(gate_idx, E).float() * validf[..., None, None]
    return {
        "fsum": assign.reshape(-1, E).sum(dim=0),  # (E,) choices sent to e
        "psum": (probs * validf[..., None]).reshape(-1, E).sum(dim=0),  # (E,)
        "zsum": (torch.logsumexp(logits, dim=-1) ** 2 * validf).sum(),
        "n": validf.sum(),
        "csum": validf.sum() * gate_idx.shape[-1],  # valid routed choices
    }


def aux_from_stats(config, stats: dict) -> torch.Tensor:
    """Weighted load-balance + z losses from :func:`router_stats` sums:
    ``E * sum_e f_e * P_e`` (f_e the share of routed choices sent to e,
    P_e the mean router probability of e) and the mean squared
    logsumexp of the logits."""
    E = stats["psum"].shape[-1]
    n = torch.clamp(stats["n"], min=1.0)
    f = stats["fsum"] / torch.clamp(stats["csum"], min=1.0)
    balance = E * (f * (stats["psum"] / n)).sum()
    z = stats["zsum"] / n
    return config.moe_aux_weight * balance + config.moe_zloss_weight * z


def zero_stats(n_experts: int, device=None) -> dict:
    """The additive identity of :func:`router_stats`."""
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return {"fsum": zeros(n_experts), "psum": zeros(n_experts), "zsum": zeros(),
            "n": zeros(), "csum": zeros()}


def _experts(p: dict, h: torch.Tensor, cd, grouped: bool) -> torch.Tensor:
    """swish(h w1 + b1) w2 + b2 with the expert axis kept free: tokens
    (B, T, D) → (B, T, E, D), or a dispatch buffer (G, E, C, D) →
    (G, E, C, D) when ``grouped``."""
    if grouped:
        eq_in, eq_out, bias = "gecd,edf->gecf", "gecf,efd->gecd", lambda b: b[:, None, :]
    else:
        eq_in, eq_out, bias = "btd,edf->btef", "btef,efd->bted", lambda b: b
    hidden = F.silu(torch.einsum(eq_in, h, p["w1"].to(cd)) + bias(p["b1"].to(cd)))
    return torch.einsum(eq_out, hidden, p["w2"].to(cd)) + bias(p["b2"].to(cd))


def _local_experts(p: dict, ep_axis) -> int:
    """The first expert this rank holds (0 without expert parallelism)."""
    return group_rank(ep_axis) * p["w1"].shape[0] if ep_axis is not None else 0


def _moe_nodrop(p: dict, xn: torch.Tensor, config, cd, valid: torch.Tensor, ep_axis=None):
    """Every expert on every token, combined by the top-k gates (zero for
    invalid tokens); under ``ep_axis`` this rank's experts, the combine
    summed over the group."""
    _, probs, gates, gate_idx = _route(p, xn, config.moe_topk)
    E = probs.shape[-1]  # the router's width: every expert
    y = _experts(p, xn, cd, grouped=False)  # (B, T, E_local, D)
    w = (F.one_hot(gate_idx, E).float() * gates[..., None]).sum(dim=-2)
    w = (w * valid[..., None].float()).to(cd)
    k0 = _local_experts(p, ep_axis)
    w = w[..., k0:k0 + p["w1"].shape[0]]
    out = torch.einsum("bte,bted->btd", w, y)
    return out if ep_axis is None else all_reduce_sum(out, ep_axis)


def capacity_slots(gate_idx: torch.Tensor, valid: torch.Tensor, E: int, C: int):
    """Slot assignment of the capacity path for one dispatch group a row:
    ``gate_idx`` (G, S, k), ``valid`` (G, S) → (slot (G, S, k) int64, the
    position of each choice in its expert's buffer, clamped to C-1;
    keep (G, S, k) bool).  Choices fill by (choice rank, then time order):
    every first choice of a group before any second choice, a cumsum
    position per expert."""
    validf = valid.float()
    base = torch.zeros(gate_idx.shape[0], E, device=gate_idx.device)  # filled slots
    slots, keeps = [], []
    for j in range(gate_idx.shape[-1]):
        choice = gate_idx[..., j : j + 1]
        oh = F.one_hot(choice[..., 0], E).float() * validf[..., None]  # (G, S, E)
        pos = torch.cumsum(oh, dim=1) - oh + base[:, None, :]
        keep = oh * (pos < C).float()
        base = base + keep.sum(dim=1)
        slots.append(torch.gather(pos, -1, choice))
        keeps.append(torch.gather(keep, -1, choice))
    slot = torch.cat(slots, dim=-1)
    keep = torch.cat(keeps, dim=-1) > 0
    return torch.clamp(slot, max=C - 1).long(), keep


def _moe_capacity_grouped(p: dict, xn: torch.Tensor, config, cd, valid: torch.Tensor,
                          ep_axis=None):
    """One dispatch group a leading-dim row: xn (G, S, D) → (G, S, D).
    Kept tokens are copied into their (expert, slot) of a (G, E, C, D)
    buffer (each slot holds at most one kept token, so the copy is exact), the
    experts run on the buffer, and each kept choice reads its slot back,
    weighted by its gate.  Under ``ep_axis`` the buffer holds this rank's
    experts only (the slots are taken over all of them first) and the
    combine is summed over the group."""
    G, S, D = xn.shape
    E, k = config.moe_experts, config.moe_topk
    C = max(int(math.ceil(k * S / E * config.moe_capacity_factor)), 1)
    _, _, gates, gate_idx = _route(p, xn, k)
    slot, keep = capacity_slots(gate_idx, valid, E, C)
    E_local = p["w1"].shape[0]
    local = gate_idx - _local_experts(p, ep_axis)
    keep = keep & (local >= 0) & (local < E_local)
    n = G * E_local * C
    g = torch.arange(G, device=xn.device)[:, None, None]
    flat = (g * E_local + local.clamp(0, E_local - 1)) * C + slot  # (G, S, k) buffer row
    # dropped, invalid (and other ranks') choices land on a spare last row
    # that no expert reads (no mask of data-dependent size, so no wait for
    # the card)
    dest = torch.where(keep, flat, n).reshape(-1)
    src = xn.to(cd)[:, :, None, :].expand(G, S, k, D).reshape(-1, D)
    buf = xn.new_zeros((n + 1, D), dtype=cd).index_put((dest,), src)
    y = _experts(p, buf[:n].reshape(G, E_local, C, D), cd, grouped=True)
    back = y.reshape(n, D)[flat]  # (G, S, k, D); dropped choices weigh 0
    w = (gates * keep.float()).to(cd)
    # the combine sums k products in f32, as an einsum in cd accumulates
    out = (w.float()[..., None] * back.float()).sum(dim=2).to(cd)
    return out if ep_axis is None else all_reduce_sum(out, ep_axis)


def _moe_capacity(p: dict, xn: torch.Tensor, config, cd, valid: torch.Tensor, ep_axis=None):
    """Grouped capacity dispatch: one group a batch row, or a
    ``moe_group_size``-step segment of a row (T padded up to whole
    segments; pad tokens are invalid and take no slot), so the capacity
    is a constant of the config."""
    B, T, D = xn.shape
    seg = int(config.moe_group_size or 0)
    if not seg:
        return _moe_capacity_grouped(p, xn, config, cd, valid, ep_axis)
    pad = (-T) % seg
    if pad:
        xn = F.pad(xn, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    G = (T + pad) // seg
    out = _moe_capacity_grouped(p, xn.reshape(B * G, seg, D), config, cd,
                                valid.reshape(B * G, seg), ep_axis)
    return out.reshape(B, G * seg, D)[:, :T]


def moe_ffn(p: dict, xn: torch.Tensor, config, cd, valid: torch.Tensor,
            stats_valid: torch.Tensor | None = None, ep_axis=None):
    """Routed MoE FFN on the LayerNormed ``xn`` (B, T, D) in the compute
    dtype; ``valid`` (B, T) bool marks the tokens inside the recording.
    Returns (out (B, T, D), :func:`router_stats` sums).  ``stats_valid``
    (default ``valid``) marks the tokens the statistics count: sequence
    parallelism leaves a shard's halo out of them, so that the sum over
    the shards counts each token once.  ``ep_axis``: expert parallelism
    over that process group (the router, hence the statistics, is the same
    on every rank of it)."""
    if config.moe_capacity_factor > 0:
        out = _moe_capacity(p, xn, config, cd, valid, ep_axis)
    else:
        out = _moe_nodrop(p, xn, config, cd, valid, ep_axis)
    logits, probs, _, gate_idx = _route(p, xn, config.moe_topk)
    return out, router_stats(logits, probs, gate_idx,
                             valid if stats_valid is None else stats_valid)
