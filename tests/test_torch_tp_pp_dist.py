"""The port's tensor and pipeline parallelism across processes, held to
the JAX package.

Three spawns of gloo ranks on the CPU (``ecog2txt_tpu_torch.parallel.
launch`` running ``tests/torch_tp_pp_worker.py``), one a world size,
several checks each; every loss, MoE aux loss and summed gradient (each
part gathered into the one-process tree) against ``jax.grad`` of the
unsharded JAX loss:

* 2 ranks: tp (model=2) of the biLSTM under ``use_pallas_lstm`` True and
  ``'bi_grid'`` (the kernels' plain versions on the CPU) and of the
  conformer under ``'fused'`` (every split leaf gathered on entry);
  pp (pp=2, M=2) of the dense conformer and of the no-drop MoE; pp with two
  subjects, whose subject-stacked leaves get a zero gradient on the other
  subject's batch; then ``fit`` under ``tensor_parallel=2`` (the JAX test's
  TINY biLSTM) and ``pipeline_parallel=2`` (conformer): the replicated
  leaves bit-identical over the ranks, each rank holding 1/2 of every tp
  leaf or its stage's blocks with their EMA and Adam moments, and the
  gathered checkpoint restored in one process equal to the ranks' tree;
* 4 ranks: dp×tp, tp×sp, dp×pp, sp×pp, ep×pp (no-drop and capacity) and
  tp×pp, and the dryrun of every mode that fits 4 ranks;
* 8 ranks: ep×sp×pp (capacity) and tp×sp×pp.

Tolerances: f32 rtol 1e-4 / atol 1e-5.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_to_numpy, tree_leaves
from ecog2txt_tpu_torch.models.seq2seq import init_seq2seq
from ecog2txt_tpu_torch.parallel.launch import spawn
from torch_dist_worker import SEQ, torch_config
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
T = 64
DENSE = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
             chunk_size=4, left_context=1)
FUSED = {**DENSE, "attention_impl": "fused"}
NODROP = {**DENSE, "moe_experts": 4, "moe_topk": 2}
# groups of 8 steps divide the shards (16 steps at T'=32 over 2) and the halo (16)
CAPACITY = {**NODROP, "moe_capacity_factor": 1.25, "moe_group_size": 8}
LSTM = {"encoder_type": "lstm"}
TWO = {"num_subjects": 2}
# name → (conformer, config extras, port-only extras): the JAX reference
# runs the biLSTM's step loops, the same function as the kernels
MODELS = {
    "lstm_true": (DENSE, LSTM, {"use_pallas_lstm": True}),
    "lstm_grid": (DENSE, LSTM, {"use_pallas_lstm": "bi_grid"}),
    "fused": (FUSED, {}, {}),
    "dense": (DENSE, {}, {}),
    "nodrop": (NODROP, {}, {}),
    "capacity": (CAPACITY, {}, {}),
    "two_subjects": (DENSE, TWO, {}),
}
# case → (model, mesh, modes, world)
CASES = {
    "tp_lstm_true": ("lstm_true", dict(n_data=1, n_model=2), {"tp": True}, 2),
    "tp_lstm_grid": ("lstm_grid", dict(n_data=1, n_model=2), {"tp": True}, 2),
    "tp_conformer_fused": ("fused", dict(n_data=1, n_model=2), {"tp": True}, 2),
    "pp_dense": ("dense", dict(n_data=1, n_pp=2), {"pp": 2}, 2),
    "pp_nodrop": ("nodrop", dict(n_data=1, n_pp=2), {"pp": 2}, 2),
    "pp_two_subjects": ("two_subjects", dict(n_data=1, n_pp=2), {"pp": 2}, 2),
    "dp_tp": ("lstm_true", dict(n_data=2, n_model=2), {"tp": True}, 4),
    "tp_sp": ("dense", dict(n_data=1, n_model=2, n_seq=2), {"tp": True, "sp": True}, 4),
    "dp_pp": ("dense", dict(n_data=2, n_pp=2), {"pp": 1}, 4),
    "sp_pp": ("dense", dict(n_data=1, n_seq=2, n_pp=2), {"sp": True, "pp": 2}, 4),
    "ep_pp_nodrop": ("nodrop", dict(n_data=1, n_model=2, n_pp=2), {"ep": True, "pp": 2}, 4),
    "ep_pp_capacity": ("capacity", dict(n_data=1, n_model=2, n_pp=2), {"ep": True, "pp": 2}, 4),
    "tp_pp": ("dense", dict(n_data=1, n_model=2, n_pp=2), {"tp": True, "pp": 2}, 4),
    "ep_sp_pp": ("capacity", dict(n_data=1, n_model=2, n_seq=2, n_pp=2),
                 {"ep": True, "sp": True, "pp": 2}, 8),
    "tp_sp_pp": ("dense", dict(n_data=1, n_model=2, n_seq=2, n_pp=2),
                 {"tp": True, "sp": True, "pp": 2}, 8),
}
TINY = {"encoder_embedding": [16], "encoder_rnn": [24], "encoder_1_projection": [16],
        "decoder_embedding": [12], "decoder_rnn": [48], "decoder_projection": []}
FIT_CONFORMER = dict(num_blocks=2, model_dim=16, num_heads=2, ffn_dim=32, conv_kernel=4,
                     chunk_size=4, left_context=1, attention_impl="flash")
FITS = {
    "tp": {"tensor_parallel": 2, "use_pallas_lstm": True},
    "pp": {"pipeline_parallel": 2, "pipeline_microbatches": 2, "encoder_type": "conformer",
           "conformer": FIT_CONFORMER},
}


def _jax_config(name):
    conformer, extra, _ = MODELS[name]
    kw = {**SEQ, **extra}
    kw["aux_heads"] = tuple(js.AuxHead(*h) for h in kw["aux_heads"])
    return js.Seq2SeqConfig(**kw, conformer=jc.ConformerConfig(**conformer))


def _torch_config(name):
    conformer, extra, port = MODELS[name]
    return torch_config(conformer, **extra, **port)


def _batch(seed, subject=0, B=4):
    rng = np.random.default_rng(seed)
    return {
        "encoder_inputs": rng.normal(size=(B, T, 8)).astype(np.float32),
        "encoder_lengths": np.array([T, T - 7, T, T // 2][:B], np.int32),
        "decoder_targets": rng.integers(2, 12, size=(B, 5)).astype(np.int32),
        "decoder_lengths": np.array([5, 3, 5, 2][:B], np.int32),
        "encoder_1_targets": rng.integers(0, 10, size=(B, T)).astype(np.int32),
        "subject_idx": np.int32(subject),
    }


def _batches(name):
    return [_batch(3, 0), _batch(8, 1)] if name == "two_subjects" else [_batch(3)]


def _jax_grads(name, params):
    cfg = _jax_config(name)

    @jax.jit
    def value_and_grad(p, batch):
        return jax.value_and_grad(
            lambda p: js.seq2seq_loss(p, cfg, batch, jax.random.PRNGKey(1), train=False),
            has_aux=True)(p)

    out = []
    for batch in _batches(name):
        (loss, metrics), grads = value_and_grad(jax.tree.map(jnp.asarray, params),
                                                jax.tree.map(jnp.asarray, batch))
        out.append({"loss": float(loss), "moe_aux": float(metrics.get("moe_aux", 0.0)),
                    "grads": jax.tree.map(np.asarray, grads)})
    return out


def _close_trees(got, want, what):
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        np.testing.assert_allclose(g, w, err_msg=f"{what} leaf {i}", **F32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three spawns, and the JAX side of every check."""
    root = tmp_path_factory.mktemp("tp_pp")
    params = {name: params_to_numpy(init_seq2seq(_torch_config(name),
                                                 torch.Generator().manual_seed(0), "cpu"))
              for name in MODELS}

    def grad_case(model, mesh, modes):
        conformer, extra, port = MODELS[model]
        return {"kind": "grads", "mesh": mesh, "modes": modes, "conformer": conformer,
                "config": {**extra, **port}, "params": params[model],
                "batches": _batches(model)}

    fits = {}
    for name, sn in FITS.items():
        manifest = tdemo.make_demo_experiment(str(root / name), subject_ids=(1,),
                                              layer_sizes=TINY, N_epochs=2)
        fits[name] = {"kind": "fit", "manifest": manifest, "epochs": 2,
                      "sn": {**sn, "batch_size": 8, "max_dec_len": 6, "learning_rate": 3e-3}}
    by_world = {w: [n for n, c in CASES.items() if c[3] == w] for w in (2, 4, 8)}
    extra = {2: list(fits.values()), 4: [{"kind": "dryrun"}], 8: []}
    one_thread = {"OMP_NUM_THREADS": "1"}
    with ThreadPoolExecutor(3) as pool:
        futures = {w: pool.submit(spawn, "torch_tp_pp_worker:run", w, {"cases": [
            *(grad_case(*CASES[n][:3]) for n in names), *extra[w]]}, timeout=400,
            pythonpath=[HERE], env=one_thread) for w, names in by_world.items()}
        # the kernels' paths compute the function of JAX's step loops and
        # dense attention, from the same parameters
        same = {"lstm_grid": "lstm_true", "fused": "dense"}
        want = {name: _jax_grads(name, params[name]) for name in MODELS if name not in same}
        ranks = {w: f.result() for w, f in futures.items()}
    for name, like in same.items():
        assert all(np.array_equal(a, b) for a, b in zip(tree_leaves(params[name]),
                                                         tree_leaves(params[like])))
        want[name] = want[like]
    got = {}
    for w, names in by_world.items():
        for i, name in enumerate(names):
            got[name] = [r[i] for r in ranks[w]]
    fit_results = {name: [r[len(by_world[2]) + i] for r in ranks[2]]
                   for i, name in enumerate(fits)}
    return {"got": got, "want": want, "fits": fits, "fit_results": fit_results,
            "dryrun": [r[-1] for r in ranks[4]], "params": params}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss_and_grads_match_jax(runs, case):
    """Every composition: the global loss, the MoE aux loss and every
    gradient leaf (each part gathered) equal ``jax.grad`` of the unsharded
    JAX loss, on every rank; with two subjects, the other subject's
    stacked subnet leaves get exactly zero."""
    model = CASES[case][0]
    for rank, result in enumerate(runs["got"][case]):
        for got, want, b in zip(result["steps"], runs["want"][model], _batches(model)):
            what = f"{case} rank {rank} subject {int(b['subject_idx'])}"
            np.testing.assert_allclose(got["loss"], want["loss"], err_msg=what, **F32)
            np.testing.assert_allclose(got["moe_aux"], want["moe_aux"], err_msg=what, **F32)
            _close_trees(got["grads"], want["grads"], what)
            if model == "two_subjects":
                w = got["grads"]["subnet"]["conv"][0]["w"]
                s = int(b["subject_idx"])
                assert np.any(w[s] != 0.0)
                np.testing.assert_array_equal(w[1 - s], np.zeros_like(w[1 - s]))
    if MODELS[model][0].get("moe_experts"):
        assert runs["want"][model][0]["moe_aux"] > 0


@pytest.mark.parametrize("case", ["tp_lstm_true", "pp_dense", "tp_pp"])
def test_ranks_hold_their_parts(runs, case):
    """Under tp each rank holds half the columns of every leaf JAX's rule
    splits (and the rest whole); under pp its stage's blocks only."""
    model, mesh, modes, _ = CASES[case]
    full = [tuple(np.shape(x)) for x in tree_leaves(runs["params"][model])]
    for result in runs["got"][case]:
        shapes = result["shapes"]
        if modes.get("pp"):
            n_block = len(tree_leaves(runs["params"][model]["encoder"]["conformer"]
                                      ["blocks"][0]))
            assert len(shapes) == len(full) - n_block
        if modes.get("tp") and not modes.get("pp"):
            halved = [s for s, f in zip(shapes, full) if s != f]
            assert halved and all(s[:-1] == f[:-1] and 2 * s[-1] == f[-1]
                                  for s, f in zip(shapes, full) if s != f)


def test_dryrun_every_mode_on_four_ranks(runs):
    """``parallel.dryrun``: each mode that fits 4 ranks took a step whose
    loss equals the one-process loss (checked on the ranks), the same on
    every rank."""
    modes = runs["dryrun"][0]
    assert set(modes) == {"dp_tp", "sp", "dp_pp", "ep", "ep_pp", "sp_pp", "tp_sp", "tp_pp"}
    assert all(r == modes for r in runs["dryrun"])
    assert all(np.isfinite(v) for v in modes.values())


@pytest.mark.parametrize("mode", list(FITS))
def test_fit_keeps_ranks_identical_and_restores_in_one_process(runs, mode):
    """``fit`` for 2 epochs under ``tensor_parallel=2`` (biLSTM, K1f/K1b's
    plain versions) and ``pipeline_parallel=2`` (conformer, 2 microbatches):
    the whole trees bit-identical over the ranks; each rank's parameters,
    EMA and both Adam moments hold its columns of the split leaves (tp) or
    its stage's block (pp), so the ranks' own leaves differ; the checkpoint
    rank 0 wrote restores in a one-process trainer to the ranks' tree bit
    for bit."""
    ranks = runs["fit_results"][mode]
    assert ranks[0]["full"] == ranks[1]["full"]
    assert ranks[0]["local"] != ranks[1]["local"]
    assert ranks[0]["epoch"] == ranks[1]["epoch"] == 2
    for r in ranks:
        shapes = r["shapes"]
        assert shapes["params"] == shapes["ema"] == shapes["exp_avg"] == shapes["exp_avg_sq"]
    if mode == "tp":
        assert ranks[0]["mesh"] == {"data": 1, "model": 2}
        assert any(s == ("model",) for s in ranks[0]["split"])
    else:
        assert ranks[0]["mesh"] == {"data": 1, "pp": 2}
        assert ranks[0]["blocks"] == 1
        assert any(s == ("pp",) for s in ranks[0]["split"])
    fit = runs["fits"][mode]
    sn = {k: v for k, v in fit["sn"].items()
          if k not in ("tensor_parallel", "pipeline_parallel", "pipeline_microbatches")}
    trainer = ttrain.MultiSubjectTrainer(fit["manifest"], [1], SN_kwargs=sn, VERBOSE=False,
                                         device="cpu")
    trainer.restore()
    assert trainer.state.epoch == 2
    for got, want in zip(tree_leaves(params_to_numpy(trainer.state.params)),
                         tree_leaves(ranks[0]["params"])):
        np.testing.assert_array_equal(got, want)
