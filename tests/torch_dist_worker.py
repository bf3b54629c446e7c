"""Rank functions for the port's multi-process tests (gloo, CPU).

The counterpart of ``tests/multihost_worker.py`` for
``ecog2txt_tpu_torch``: ``tests/test_torch_parallel_dist.py`` starts the
ranks with ``ecog2txt_tpu_torch.parallel.launch.spawn`` and each rank runs
one of these functions after ``initialize_distributed``.  This module
imports torch and the port only (no JAX): the test process computes the
JAX side and hands the ranks numpy inputs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ecog2txt_tpu_torch.convert import params_from_numpy, params_to_numpy, tree_leaves, tree_map
from ecog2txt_tpu_torch.models.conformer import ConformerConfig
from ecog2txt_tpu_torch.models.seq2seq import AuxHead, Seq2SeqConfig, seq2seq_loss
from ecog2txt_tpu_torch.parallel import (
    batch_sharding,
    gather_params_ep,
    make_dp_train_step,
    make_mesh,
    shard_params_ep,
)
from ecog2txt_tpu_torch.parallel.expert import expert_mask
from ecog2txt_tpu_torch.parallel.mesh import parallel_modes, reduce_gradients_
from ecog2txt_tpu_torch.train import (
    MultiSubjectTrainer,
    TrainState,
    make_optimizer,
    make_segment_runner,
)

SEQ = dict(vocab_size=12, num_subjects=1, in_channels=8, conv_sizes=(16,),
           decimation_factor=2, rnn_sizes=(24,), aux_proj_sizes=(16,),
           aux_heads=(("encoder_1_targets", "categorical", 10),),
           dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6,
           encoder_type="conformer")


def torch_config(conformer: dict, **extra) -> Seq2SeqConfig:
    kw = {**SEQ, **extra}
    kw["aux_heads"] = tuple(AuxHead(*h) for h in kw["aux_heads"])
    return Seq2SeqConfig(**kw, conformer=ConformerConfig(**conformer))


def _tensors(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()
           if k != "subject_idx"}
    out["subject_idx"] = int(batch["subject_idx"])
    return out


def _grads(case: dict) -> dict:
    """The global loss, aux and gradients of one ``seq2seq_loss`` on a mesh
    of ``case['mesh']`` = (data, model, seq) with the parallel modes the
    mesh's axes name (dp when data > 1, ep when model > 1, sp when seq >
    1), dropout off."""
    n_data, n_model, n_seq = case["mesh"]
    mesh = make_mesh(n_data, n_model, n_seq)
    cfg = torch_config(case["conformer"])
    E = cfg.conformer.moe_experts
    full = params_from_numpy(case["params"], "cpu")
    params = shard_params_ep(full, mesh, E) if n_model > 1 else full
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _tensors(case["batch"])
    if n_data > 1:
        batch = batch_sharding(mesh)(batch)
    loss, metrics = seq2seq_loss(params, cfg, batch, None, train=False,
                                 **parallel_modes(mesh, "ep" if n_model > 1 else None))
    loss.backward()
    leaves = tree_leaves(params)
    sharded = tree_leaves(expert_mask(params, E // n_model)) if n_model > 1 else None
    reduce_gradients_([p.grad for p in leaves], mesh, sharded)
    grads = _tree_like(params, [p.grad for p in leaves])
    if n_model > 1:
        grads = gather_params_ep(grads, mesh, E)
    return {"loss": float(metrics["loss_total"]),
            "moe_aux": float(metrics.get("moe_aux", torch.zeros(()))),
            "grads": params_to_numpy(grads)}


def _tree_like(tree, leaves: list):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return next(it)

    return walk(tree)


def _dp_steps(case: dict) -> dict:
    """``make_dp_train_step`` over the data axis for each of
    ``case['batches']``: (clip 10, Adam at ``lr``, EMA ``decay``); returns
    the losses and the parameters and EMA after the steps."""
    mesh = make_mesh(case["mesh"][0], 1, 1)
    cfg = torch_config(case["conformer"])
    params = params_from_numpy(case["params"], "cpu")
    ema = params_from_numpy(case["params"], "cpu")
    optimizer = make_optimizer(params, case["lr"])
    step = make_dp_train_step(
        lambda p, b, g: seq2seq_loss(p, cfg, b, g, train=False, dp=(mesh, "data")),
        case["decay"], mesh, clip_norm=10.0,
    )
    losses = [float(step(params, ema, optimizer, _tensors(b))[0]) for b in case["batches"]]
    return {"losses": losses, "params": params_to_numpy(params), "ema": params_to_numpy(ema)}


def runner_steps(case: dict, mesh=None) -> dict:
    """The trainer's segment runner (``train.make_segment_runner``: clip
    10, Adam at ``lr``, EMA ``decay``, dropout off) one step a segment over
    ``case['indices']`` (batches of any size, an odd one first), on
    ``mesh`` (None: in one process).  Returns the first step's summed,
    clipped gradients, the losses, and the parameters, EMA and Adam moments
    after the steps."""
    cfg = torch_config(case["conformer"], FF_dropout=0.0, RNN_dropout=0.0)
    params = params_from_numpy(case["params"], "cpu")
    state = TrainState(params, params_from_numpy(case["params"], "cpu"),
                       make_optimizer(params, case["lr"]), 0)
    run = make_segment_runner(cfg, {}, case["decay"], mesh)
    data = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case["data"].items()}
    gen = torch.Generator().manual_seed(0)
    losses, first = [], None
    for idx in case["indices"]:
        state, metrics = run(state, data, np.zeros(1, np.int32), np.asarray(idx)[None], gen, 0)
        losses.append(float(metrics["loss_total"]))
        if first is None:
            first = _tree_like(params, [p.grad.detach().clone() for p in tree_leaves(params)])
    adam = state.opt_state.adam.state
    moments = {k: _tree_like(params, [adam[p][k] for p in tree_leaves(params)])
               for k in ("exp_avg", "exp_avg_sq")}
    return {"losses": losses, "grads": params_to_numpy(first),
            "params": params_to_numpy(state.params), "ema": params_to_numpy(state.ema),
            **{k: params_to_numpy(v) for k, v in moments.items()}}


def _runner(case: dict) -> dict:
    return runner_steps(case, make_mesh(*case["mesh"]))


def _digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _fit(case: dict) -> dict:
    """``MultiSubjectTrainer.fit`` under ``case['sn']`` for
    ``case['epochs']``, then a checkpoint; every rank reports the digest
    of its own leaves and of the whole trees (experts gathered)."""
    trainer = MultiSubjectTrainer(case["manifest"], [1], SN_kwargs=case["sn"],
                                  VERBOSE=False, device="cpu")
    trainer.fit(num_epochs=case["epochs"], assess=False)
    path = trainer.save_checkpoint()
    full = trainer.full_params(tree=trainer.state.params)
    out = {"local": _digest(trainer.state.params), "full": _digest(full),
           "mesh": dict(trainer.mesh.shape), "checkpoint": path,
           "epoch": int(trainer.state.epoch)}
    if trainer.mesh.rank == 0:  # a copy: the diverging fit below moves the leaves
        out["params"] = tree_map(lambda t: t.detach().numpy().copy(), full)
    if case.get("diverge"):
        # a learning rate that diverges: every rank rolls back to the
        # checkpoint and raises, in lockstep
        trainer.learning_rate = 1e18
        try:
            trainer.fit(num_epochs=1, assess=False)
        except FloatingPointError as err:
            out["diverged"] = str(err)
        out["after_rollback"] = _digest(trainer.full_params(tree=trainer.state.params))
    return out


def run(cases: list[dict]) -> list[dict]:
    """Each case in turn, on every rank (the collectives pair up)."""
    kinds = {"grads": _grads, "dp_steps": _dp_steps, "runner": _runner, "fit": _fit}
    return [kinds[case["kind"]](case) for case in cases]
