"""Rank functions for the port's tensor- and pipeline-parallel tests (gloo,
CPU).

``tests/test_torch_tp_pp_dist.py`` starts the ranks with
``ecog2txt_tpu_torch.parallel.launch.spawn``; each rank runs :func:`run`
after ``initialize_distributed``.  Like ``tests/torch_dist_worker.py`` this
module imports torch and the port only: the test process computes the JAX
side and hands the ranks numpy inputs.
"""

from __future__ import annotations

import torch

from ecog2txt_tpu_torch.convert import params_from_numpy, params_to_numpy, tree_leaves
from ecog2txt_tpu_torch.models.seq2seq import seq2seq_loss
from ecog2txt_tpu_torch.parallel import batch_sharding, make_mesh
from ecog2txt_tpu_torch.parallel.mesh import Placement, reduce_gradients_
from ecog2txt_tpu_torch.train import MultiSubjectTrainer
from torch_dist_worker import _digest, _tensors, _tree_like, torch_config


def _grads(case: dict) -> dict:
    """The global loss, aux and gradients (every part gathered: the
    one-process tree) of ``seq2seq_loss`` for each of ``case['batches']``,
    dropout off, on a mesh of ``case['mesh']`` with ``case['modes']``; and
    the shapes of this rank's leaves."""
    mesh = make_mesh(**case["mesh"])
    modes = case["modes"]
    cfg = torch_config(case["conformer"], **case.get("config", {}))
    full = params_from_numpy(case["params"], "cpu")
    placement = Placement(mesh, full, tp=bool(modes.get("tp")), pp=bool(modes.get("pp")),
                          experts=cfg.conformer.moe_experts if modes.get("ep") else 0)
    params = placement.place(full)
    split = placement.split(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = []
    for b in case["batches"]:
        batch = _tensors(b)
        if mesh.shape["data"] > 1:
            batch = batch_sharding(mesh)(batch)
        for p in leaves:
            p.grad = None
        loss, metrics = seq2seq_loss(params, cfg, batch, None, train=False,
                                     **placement.modes(modes.get("pp")))
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        reduce_gradients_(grads, mesh, split)
        tree = placement.gather(_tree_like(params, grads))
        out.append({"loss": float(metrics["loss_total"]),
                    "moe_aux": float(metrics.get("moe_aux", torch.zeros(()))),
                    "grads": params_to_numpy(tree)})
    return {"steps": out, "shapes": [tuple(p.shape) for p in leaves]}


def _fit(case: dict) -> dict:
    """``MultiSubjectTrainer.fit`` under ``case['sn']`` for
    ``case['epochs']``, then a checkpoint: the digests of this rank's
    leaves and of the whole trees, the shapes of this rank's parameters, EMA
    and Adam moments, and (rank 0) the whole parameters."""
    trainer = MultiSubjectTrainer(case["manifest"], [1], SN_kwargs=case["sn"],
                                  VERBOSE=False, device="cpu")
    trainer.fit(num_epochs=case["epochs"], assess=False)
    trainer.save_checkpoint()
    full = trainer.full_params(tree=trainer.state.params)
    adam = trainer.state.opt_state.adam.state
    leaves = tree_leaves(trainer.state.params)
    out = {"local": _digest(trainer.state.params), "full": _digest(full),
           "mesh": dict(trainer.mesh.shape), "epoch": int(trainer.state.epoch),
           "shapes": {"params": [tuple(p.shape) for p in leaves],
                      "ema": [tuple(p.shape) for p in tree_leaves(trainer.state.ema)],
                      "exp_avg": [tuple(adam[p]["exp_avg"].shape) for p in leaves],
                      "exp_avg_sq": [tuple(adam[p]["exp_avg_sq"].shape) for p in leaves]},
           "split": trainer._placement.split(trainer.state.params),
           "blocks": len(trainer.state.params["encoder"].get("conformer", {}).get("blocks", []))}
    if trainer.mesh.rank == 0:
        out["params"] = params_to_numpy(full)
    return out


def _dryrun(case: dict) -> dict:
    from ecog2txt_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip("cpu")


def run(cases: list[dict]) -> list[dict]:
    """Each case in turn, on every rank (the collectives pair up)."""
    kinds = {"grads": _grads, "fit": _fit, "dryrun": _dryrun}
    return [kinds[case["kind"]](case) for case in cases]
