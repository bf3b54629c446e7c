"""The comparison that decides ``correct``: the numbers and their limits.

Training (the first ``checked_steps`` steps of the run: the first step as
one call of the segment runner, the others as one more, followed by the
reference from the same weights, rows and dropout masks):

* ``loss1``: the relative gap of the first step's loss;
* ``loss1.<head>``: the same for each head's loss (the auxiliary heads by
  name, ``decoder_targets``);
* ``loss``: the relative gap of the second call's mean loss;
* ``grad1``: the clipped gradient of step 1 as the optimizer got it, the
  worst leaf's gap between the program's norm and the reference's;
* ``grad1.median``: the norm of the difference between the program's and
  the reference's first gradient, the median leaf's;
* ``grad1.vs_bf16``: that norm of the difference over the same norm for
  the reference with bfloat16 operands (the precision the cells state),
  the worst leaf's among the leaves that this bfloat16 reference keeps
  within ``WELL_KEPT`` of the float32 one: about 1 for a sound program on
  every seed, where the plain gap swings with how far bfloat16 can follow
  the first gradient through the recurrences on that seed's draw;
* ``delta``: each leaf's change over the checked steps, the worst leaf's
  gap of norms;
* ``ema``: the same for each leaf's EMA change.

Each leaf's reading is over the larger of the reference's norm of that
leaf and of the median leaf.  ``delta`` and ``ema`` leave out the leaves
whose reference gradient is under a thousandth of the median leaf's
(round-off alone moves them under Adam).

Decoding: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best, over the positions up to each row's
first ``<EOS>``.

A run is correct when every number the cell's ``limits/<workload>.json``
names is finite and within its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import seq2seq as ref

NEGLIGIBLE_GRADIENT = 1e-3  # of the median leaf's reference gradient norm
WELL_KEPT = 0.1  # a leaf's first-gradient reading of the bfloat16 reference


def _norms(tensors) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in tensors])


def _over_scale(values: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Each leaf's reading over the larger of its reference norm and the
    median leaf's."""
    return values / np.maximum(scale, max(float(np.median(scale)), 1e-30))


def _changes(after, leaves0) -> list:
    return [a.float() - b.float() for a, b in zip(after, leaves0)]


def leaf_readings(got: dict, want: dict, leaves0: list) -> dict:
    """Per-leaf readings behind the training numbers (leaf order): gaps of
    norms of the first gradient (``grad1``), of the change and of the EMA's
    change, and the norm of the first gradient's difference
    (``grad1_diff``), each over its scale."""
    out = {}
    for key, (a, b) in {"grad1": (got["grads1"], want["grads1"]),
                        "delta": (_changes(got["params"], leaves0),
                                  _changes(want["params"], leaves0)),
                        "ema": (_changes(got["ema"], leaves0), _changes(want["ema"], leaves0))
                        }.items():
        na, nb = _norms(a), _norms(b)
        out[key] = _over_scale(np.abs(na - nb), nb)
    diff = [a.float() - b.float() for a, b in zip(got["grads1"], want["grads1"])]
    out["grad1_diff"] = _over_scale(_norms(diff), _norms(want["grads1"]))
    return out


def kept_leaves(want: dict) -> np.ndarray:
    """The leaves whose reference gradient at the first step is not
    negligible."""
    g = _norms(want["grads1"])
    return g >= NEGLIGIBLE_GRADIENT * np.median(g)


def grad1_vs_bf16(got: dict, want: dict, witness: dict) -> float:
    """The worst ratio, over the leaves whose first gradient the bfloat16
    reference ``witness`` keeps within ``WELL_KEPT`` of the float32
    reference ``want`` (the best-kept leaf where none is), of the
    program's gap from ``want`` to the witness's."""
    diff = lambda side: _over_scale(  # noqa: E731
        _norms([a.float() - b.float() for a, b in zip(side["grads1"], want["grads1"])]),
        _norms(want["grads1"]))
    program, bf16 = diff(got), diff(witness)
    kept = bf16 < WELL_KEPT
    if not kept.any():
        kept = bf16 == bf16.min()
    return float(np.max(program[kept] / np.maximum(bf16[kept], 1e-30)))


def train_numbers(got: dict, want: dict, leaves0: list, witness: dict | None = None) -> dict:
    """``got``: the program's first-step losses and clipped gradient, the
    second call's mean loss, the parameters and the EMA after it (leaf
    order); ``want``: the reference's (``reference.seq2seq.train_steps``);
    ``witness``: the reference's first step with bfloat16 operands, for
    ``grad1.vs_bf16``."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    keep = kept_leaves(want)
    leaf = leaf_readings(got, want, leaves0)
    return {
        "loss1": rel(got["loss1"], want["losses"][0]),
        **{f"loss1.{k}": rel(v, want["parts"][0][k]) for k, v in got["parts1"].items()},
        "loss": rel(got["loss"], float(np.mean(want["losses"][1:]))),
        "grad1": float(np.max(leaf["grad1"])),
        "grad1.median": float(np.median(leaf["grad1_diff"])),
        "delta": float(np.max(leaf["delta"][keep])),
        "ema": float(np.max(leaf["ema"][keep])),
        **({"grad1.vs_bf16": grad1_vs_bf16(got, want, witness)} if witness else {}),
    }


def _valid_positions(tokens: np.ndarray, eos_id: int) -> np.ndarray:
    """(B, L) bool: the positions up to and including each row's first
    EOS; past it the decoder emits ``<pad>`` whatever its logits."""
    is_eos = tokens == eos_id
    before = np.cumsum(is_eos, axis=1) - is_eos
    return before == 0


def decode_gap(weights, model: dict, inputs, lengths, served: np.ndarray, precision: str,
               rows_per_block=None) -> float:
    """The widest gap below the reference's best logit of the served
    tokens (``precision`` float32) or of the tokens ``precision`` puts first
    at the same positions (the control)."""
    tokens = torch.as_tensor(served, dtype=torch.long, device=inputs.device)
    exact = ref.decode_logits(weights, model, inputs, lengths, 0, tokens, "float32",
                              rows_per_block)
    if precision == "float32":
        chosen = tokens
    else:
        chosen = ref.decode_logits(weights, model, inputs, lengths, 0, tokens, precision,
                                   rows_per_block).argmax(dim=-1)
    gap = exact.max(dim=-1).values - torch.gather(exact, -1, chosen[..., None])[..., 0]
    valid = torch.as_tensor(_valid_positions(served, int(model["eos_id"])), device=gap.device)
    return float(gap[valid].max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number that has a limit is finite and within it, and
    those numbers beside their limits for the result line.  A number with
    no limit in the cell's file is not compared (``PERF.md`` says why)."""
    compared = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
