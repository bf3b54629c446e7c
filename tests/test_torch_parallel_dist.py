"""The port's data, sequence and expert parallelism across processes,
held to the JAX package.

Two spawns of gloo ranks on the CPU (``ecog2txt_tpu_torch.parallel.launch``
running ``tests/torch_dist_worker.py``), several checks each:

* 2 ranks: the data-parallel step (``make_dp_train_step``, clip 10, Adam,
  EMA) against JAX's ``make_dp_train_step`` on a ``data=2`` mesh, with
  ragged lengths so that the ranks' token counts differ; the trainer's
  segment runner, which takes its steps there, on batches of 3 and 4
  against the one-process runner; the
  sequence-parallel gradients (seq=2) and the expert-parallel aux loss and
  gradients (model=2, no-drop and capacity) against ``jax.grad`` of the
  unsharded loss (which JAX's own sharded encodes equal); then ``fit``
  under ``data_parallel``, ``sequence_parallel=2`` and
  ``expert_parallel=2``: the ranks' parameters bit-identical, and the
  checkpoint restored in one process equal to rank 0's trees bit for bit;
* 4 ranks: ep×sp (model=2 × seq=2, capacity and no-drop), dp×sp and dp×ep
  against the unsharded JAX loss and gradients.

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the gloo sums change the order of
summation only).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.parallel import make_dp_train_step, make_mesh
import torch

from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_to_numpy, tree_leaves
from ecog2txt_tpu_torch.models.seq2seq import init_seq2seq
from ecog2txt_tpu_torch.parallel.launch import spawn
from torch_dist_worker import SEQ, runner_steps, torch_config
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
DENSE = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
             chunk_size=4, left_context=1)
NODROP = {**DENSE, "moe_experts": 4, "moe_topk": 2}
# groups of 8 steps divide both the shard (16 steps at T'=32 over 2) and
# the halo (16)
CAPACITY = {**NODROP, "moe_capacity_factor": 1.25, "moe_group_size": 8}
T = 64
TINY = {"encoder_embedding": [24], "encoder_rnn": [32, 32], "encoder_1_projection": [24],
        "decoder_embedding": [16], "decoder_rnn": [32], "decoder_projection": []}
FIT_CONFORMER = dict(num_blocks=1, model_dim=16, num_heads=2, ffn_dim=32, conv_kernel=4,
                     chunk_size=4, left_context=1, attention_impl="flash")


def _jax_config(conformer):
    kw = dict(SEQ)
    kw["aux_heads"] = tuple(js.AuxHead(*h) for h in kw["aux_heads"])
    return js.Seq2SeqConfig(**kw, conformer=jc.ConformerConfig(**conformer))


def _batch(seed, B=4):
    rng = np.random.default_rng(seed)
    return {
        "encoder_inputs": rng.normal(size=(B, T, 8)).astype(np.float32),
        "encoder_lengths": np.array([T, T - 7, T, T // 2][:B], np.int32),
        "decoder_targets": rng.integers(2, 12, size=(B, 5)).astype(np.int32),
        "decoder_lengths": np.array([5, 3, 5, 2][:B], np.int32),
        "encoder_1_targets": rng.integers(0, 10, size=(B, T)).astype(np.int32),
        "subject_idx": np.int32(0),
    }


def _corpus(seed, N=8):
    """One subject's stacked (1, N, ...) trials with ragged lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 6, size=N).astype(np.int32)
    dec = rng.integers(2, 12, size=(N, 5)).astype(np.int32)
    dec = np.where(np.arange(5) >= lens[:, None], 0, dec).astype(np.int32)
    data = {
        "encoder_inputs": rng.normal(size=(N, T, 8)).astype(np.float32),
        "encoder_lengths": rng.integers(T // 2, T + 1, size=N).astype(np.int32),
        "decoder_targets": dec,
        "decoder_lengths": lens,
        "encoder_1_targets": rng.integers(0, 10, size=(N, T)).astype(np.int32),
    }
    return {k: v[None] for k, v in data.items()}


def _params(conformer):
    """One parameter tree for both packages (the port's init; the layout
    is JAX's)."""
    return params_to_numpy(init_seq2seq(torch_config(conformer),
                                        torch.Generator().manual_seed(0), "cpu"))


def _jax_grads(conformer, params, batch):
    cfg = _jax_config(conformer)

    def loss_fn(p):
        return js.seq2seq_loss(p, cfg, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(1), train=False)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return {"loss": float(loss), "moe_aux": float(metrics.get("moe_aux", 0.0)),
            "grads": jax.tree.map(np.asarray, grads)}


def _jax_dp_steps(params, batches, lr, decay):
    cfg = _jax_config(DENSE)
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    step = make_dp_train_step(
        lambda p, b, r: js.seq2seq_loss(p, cfg, b, r, train=False), optimizer, decay, mesh)
    p = jax.tree.map(jnp.asarray, params)
    ema, opt_state = p, optimizer.init(p)
    losses = []
    for b in batches:
        p, ema, opt_state, loss, _ = step(p, ema, opt_state, jax.tree.map(jnp.asarray, b),
                                          jax.random.PRNGKey(2))
        losses.append(float(loss))
    return {"losses": losses, "params": jax.tree.map(np.asarray, p),
            "ema": jax.tree.map(np.asarray, ema)}


def _close_trees(got, want, what, tol=F32):
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **tol)


GRAD_CASES_2 = {"sp": ((1, 1, 2), DENSE), "ep_nodrop": ((1, 2, 1), NODROP),
                "ep_capacity": ((1, 2, 1), CAPACITY)}
GRAD_CASES_4 = {"ep_sp_capacity": ((1, 2, 2), CAPACITY), "ep_sp_nodrop": ((1, 2, 2), NODROP),
                "dp_sp": ((2, 1, 2), DENSE), "dp_ep": ((2, 2, 1), NODROP)}
FITS = {
    "dp": {"data_parallel": True},
    # lazy shards read from the records by the prefetch worker, 16 trials a
    # shard; then a diverging fit rolls every rank back in lockstep
    "dp_lazy": {"data_parallel": True, "max_host_trials": 16},
    "sp": {"sequence_parallel": 2, "encoder_type": "conformer", "conformer": FIT_CONFORMER},
    "ep": {"expert_parallel": 2, "encoder_type": "conformer",
           "conformer": {**FIT_CONFORMER, "moe_experts": 4, "moe_topk": 2,
                         "moe_capacity_factor": 1.25}},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, and the JAX side of every check."""
    root = tmp_path_factory.mktemp("dist")
    params = {name: _params(c) for name, c in
              (("dense", DENSE), ("nodrop", NODROP), ("capacity", CAPACITY))}
    by_conformer = {id(DENSE): "dense", id(NODROP): "nodrop", id(CAPACITY): "capacity"}
    batch = _batch(3)
    dp_batches = [_batch(4), _batch(5)]
    lr, decay = 1e-2, 0.9
    # the segment runner under data_parallel: an odd batch first (each
    # rank takes it whole), then one that splits
    runner = {"kind": "runner", "mesh": (2, 1, 1), "conformer": DENSE,
              "params": params["dense"], "data": _corpus(6),
              "indices": [[5, 0, 3], [1, 6, 2, 7], [4, 2, 0]], "lr": 1e-3, "decay": decay}

    def grad_case(mesh, conformer):
        return {"kind": "grads", "mesh": mesh, "conformer": conformer,
                "params": params[by_conformer[id(conformer)]], "batch": batch}

    fits = []
    for name, sn in FITS.items():
        manifest = tdemo.make_demo_experiment(str(root / name), subject_ids=(1,),
                                              layer_sizes=TINY, N_epochs=2)
        fits.append({"kind": "fit", "manifest": manifest, "epochs": 2,
                     "diverge": name == "dp_lazy",
                     "sn": {**sn, "batch_size": 8, "max_dec_len": 6, "learning_rate": 3e-3}})
    # the ranks run (one torch thread each) while this process computes
    # the JAX side
    one_thread = {"OMP_NUM_THREADS": "1"}
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(spawn, "torch_dist_worker:run", 2, {"cases": [
            {"kind": "dp_steps", "mesh": (2, 1, 1), "conformer": DENSE,
             "params": params["dense"], "batches": dp_batches, "lr": lr, "decay": decay},
            runner,
            *(grad_case(*c) for c in GRAD_CASES_2.values()),
            *fits,
        ]}, timeout=300, pythonpath=[HERE], env=one_thread)
        four = pool.submit(spawn, "torch_dist_worker:run", 4, {"cases": [
            grad_case(*c) for c in GRAD_CASES_4.values()]}, timeout=300, pythonpath=[HERE],
            env=one_thread)
        jax_dp = _jax_dp_steps(params["dense"], dp_batches, lr, decay)
        one_process = runner_steps(runner)
        jax_grads = {name: _jax_grads(c, params[name], batch) for name, c in
                     (("dense", DENSE), ("nodrop", NODROP), ("capacity", CAPACITY))}
        two, four = two.result(), four.result()
    names_2 = ["dp_steps", "runner", *GRAD_CASES_2, *(f"fit_{n}" for n in FITS)]
    return {
        "ranks_2": [dict(zip(names_2, r)) for r in two],
        "ranks_4": [dict(zip(GRAD_CASES_4, r)) for r in four],
        "jax_dp": jax_dp,
        "one_process_runner": one_process,
        "jax_grads": jax_grads,
        "fits": {n: f for n, f in zip(FITS, fits)},
    }


def test_dp_step_matches_jax_make_dp_train_step(runs):
    """Two steps over a data=2 mesh with ragged lengths (the ranks' token
    counts differ): the global losses, parameters and EMA equal JAX's (the
    parameters to atol 1e-4, as in ``test_segment_runner_matches_jax``:
    Adam divides each gradient by its running RMS), the ranks bit-identical."""
    want = runs["jax_dp"]
    ranks = [r["dp_steps"] for r in runs["ranks_2"]]
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], **F32)
    _close_trees(ranks[0]["params"], want["params"], "params", dict(rtol=1e-4, atol=1e-4))
    _close_trees(ranks[0]["ema"], want["ema"], "ema", dict(rtol=1e-4, atol=1e-4))
    for a, b in zip(jax.tree.leaves(ranks[0]["params"]), jax.tree.leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_runner_under_dp_matches_one_process(runs):
    """The trainer's segment runner on a data=2 mesh, a batch of 3 (which
    each rank takes whole) then of 4 and 3: the first step's summed,
    clipped gradients, the losses, the Adam moments, the parameters and
    the EMA equal the one-process runner's, the ranks bit-identical.  The
    clip does not fire there (|g| < 10), so a gradient summed n times
    shows in the gradients and the first moments at their full size."""
    want = runs["one_process_runner"]
    ranks = [r["runner"] for r in runs["ranks_2"]]
    norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree.leaves(want["grads"])))
    assert 0 < norm < 10.0
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"], **F32)
    for key in ("grads", "exp_avg", "exp_avg_sq", "params", "ema"):
        _close_trees(ranks[0][key], want[key], f"runner {key}")
        for a, b in zip(jax.tree.leaves(ranks[0][key]), jax.tree.leaves(ranks[1][key])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [*GRAD_CASES_2, *GRAD_CASES_4])
def test_sharded_loss_and_grads_match_jax(runs, case):
    """sp, ep (no-drop, capacity), ep×sp, dp×sp and dp×ep: the global loss,
    the MoE aux loss and every gradient leaf (experts gathered) equal the
    unsharded JAX step's, on every rank."""
    where = "ranks_2" if case in GRAD_CASES_2 else "ranks_4"
    conformer = {**GRAD_CASES_2, **GRAD_CASES_4}[case][1]
    name = {id(DENSE): "dense", id(NODROP): "nodrop", id(CAPACITY): "capacity"}[id(conformer)]
    want = runs["jax_grads"][name]
    for rank, result in enumerate(r[case] for r in runs[where]):
        got = result
        np.testing.assert_allclose(got["loss"], want["loss"], err_msg=f"rank {rank}", **F32)
        np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], err_msg=f"rank {rank}",
                                   **F32)
        _close_trees(got["grads"], want["grads"], f"{case} rank {rank} grads")
    if conformer is not DENSE:
        assert want["moe_aux"] > 0


@pytest.mark.parametrize("mode", list(FITS))
def test_fit_keeps_ranks_identical_and_restores_in_one_process(runs, mode):
    """``fit`` for 2 epochs under ``data_parallel`` (biLSTM; resident, and
    lazy shards through the prefetch worker), ``sequence_parallel = 2``
    (conformer) and ``expert_parallel = 2`` (capacity MoE): the ranks'
    whole trees bit-identical (under ep each rank's own experts differ), the
    checkpoint rank 0 wrote restores in a one-process trainer to rank 0's
    trees bit for bit.  With the lazy shards a diverging fit (learning rate
    1e18) raises on every rank, each rolled back to that checkpoint."""
    ranks = [r[f"fit_{mode}"] for r in runs["ranks_2"]]
    assert ranks[0]["full"] == ranks[1]["full"]
    assert ranks[0]["epoch"] == ranks[1]["epoch"] == 2
    if mode == "ep":
        assert ranks[0]["local"] != ranks[1]["local"]
        assert ranks[0]["mesh"] == {"data": 1, "model": 2}
    else:
        assert ranks[0]["local"] == ranks[1]["local"]
    if fit_diverges := runs["fits"][mode]["diverge"]:
        for r in ranks:
            assert "restored checkpoint at epoch 2" in r["diverged"]
            assert r["after_rollback"] == ranks[0]["full"]
    assert fit_diverges == (mode == "dp_lazy")
    fit = runs["fits"][mode]
    sn = {k: v for k, v in fit["sn"].items()
          if k not in ("data_parallel", "sequence_parallel", "expert_parallel",
                       "max_host_trials")}
    trainer = ttrain.MultiSubjectTrainer(fit["manifest"], [1], SN_kwargs=sn, VERBOSE=False,
                                         device="cpu")
    trainer.restore()
    assert trainer.state.epoch == 2
    for got, want in zip(tree_leaves(params_to_numpy(trainer.state.params)),
                         tree_leaves(ranks[0]["params"])):
        np.testing.assert_array_equal(got, want)
