"""The port's training slice held to the JAX package at small sizes.

``seq2seq_loss`` (value, metrics, every gradient leaf at ``train=False``)
for the categorical, Gaussian and Rayleigh heads against
``jax.value_and_grad``; the dropout masks' keep rate and scaling; one
segment of the segment runner against JAX's ``make_segment_runner`` at
dropout 0; the data side (demo experiment, records, packing, schedules,
WER) against the JAX package's copies; and ``MultiSubjectTrainer`` on the
demo experiment at tiny widths, on the CPU.  Parameters come from the JAX
``init_seq2seq`` (``params_from_numpy``), inputs from a numpy seed.
Tolerances: f32 rtol 1e-4 / atol 1e-5 unless a test says why it needs
more.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecog2txt_tpu import assess as jassess
from ecog2txt_tpu import config as jconfig
from ecog2txt_tpu import demo as jdemo
from ecog2txt_tpu import pipeline as jpipeline
from ecog2txt_tpu import subjects as jsubjects
from ecog2txt_tpu import tokenizers as jtokenizers
from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import assess as tassess
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import pipeline as tpipeline
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_map
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.serve import OnlinePredictor
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
B, T, C, L = 3, 24, 5, 5
LENGTHS = np.array([24, 17, 9], np.int32)
TINY = {
    "encoder_embedding": [24],
    "encoder_rnn": [32, 32],
    "encoder_1_projection": [24],
    "decoder_embedding": [16],
    "decoder_rnn": [64],
    "decoder_projection": [],
}
SN = {"batch_size": 16, "max_dec_len": 10, "learning_rate": 3e-3}


HEADS = ("categorical", "Gaussian", "Rayleigh")


def _configs(head="categorical", use_pallas=True, **extra):
    """Both packages' configs; ``head`` is one distribution (one aux
    head named 'aux') or 'all' (one head per distribution, named by
    it)."""
    kw = dict(
        vocab_size=20, in_channels=C, conv_sizes=(6,), decimation_factor=3,
        rnn_sizes=(8, 8), aux_proj_sizes=(7,), dec_embedding_size=6,
        dec_rnn_sizes=(12,), max_dec_len=L,
    )
    kw.update(extra)
    if head == "all":
        heads = tuple((h, h, 4) for h in HEADS)
    else:
        heads = (("aux", head, 4),)
    jcfg = js.Seq2SeqConfig(
        **{**kw, "aux_heads": tuple(js.AuxHead(*h) for h in heads)}
    )
    tcfg = ts.Seq2SeqConfig(
        **{**kw, "aux_heads": tuple(ts.AuxHead(*h) for h in heads),
           "use_pallas_lstm": use_pallas}
    )
    return jcfg, tcfg


def _aux_targets(rng, dist, n):
    if dist == "categorical":
        return rng.integers(0, 4, size=(n, T)).astype(np.int32)
    if dist == "Gaussian":
        return rng.normal(size=(n, T, 4)).astype(np.float32)
    return rng.rayleigh(size=(n, T, 4)).astype(np.float32)


def _batch(head, seed=0, n=B):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, L + 1, size=n).astype(np.int32)
    dec = rng.integers(3, 20, size=(n, L)).astype(np.int32)
    pos = np.arange(L)
    dec = np.where(pos == lens[:, None] - 1, 1, dec)
    dec = np.where(pos >= lens[:, None], 0, dec).astype(np.int32)
    batch = {
        "encoder_inputs": rng.normal(size=(n, T, C)).astype(np.float32),
        "encoder_lengths": (LENGTHS if n == B else
                            rng.integers(6, T + 1, size=n)).astype(np.int32),
        "decoder_targets": dec,
        "decoder_lengths": lens,
    }
    if head == "all":
        for dist in HEADS:
            batch[dist] = _aux_targets(rng, dist, n)
    else:
        batch["aux"] = _aux_targets(rng, head, n)
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["subject_idx"] = 0
    return out


def _assert_trees_close(got, want, tol=F32, path="params"):
    """``got`` a torch tree, ``want`` the same tree with numpy leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{path}/{i}")
    else:
        g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(g, np.asarray(want, np.float32), err_msg=path, **tol)


SCALES = {"categorical": 0.5, "Gaussian": 0.25, "Rayleigh": 0.125,
          "decoder_targets": 1.0}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX's loss, metrics and gradients for the three-head model (one
    compile, shared by the cases below)."""
    jcfg, _ = _configs("all")
    jp = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch("all").items()}
    jb["subject_idx"] = jnp.asarray(0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: js.seq2seq_loss(
            p, jcfg, jb, jax.random.PRNGKey(0), train=False, penalty_scales=SCALES
        ),
        has_aux=True,
    ))(jp)
    return jax.tree.map(np.asarray, (jp, loss, metrics, grads))


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(use_pallas):
    _, tcfg = _configs("all", use_pallas)
    tree = _jax_loss_and_grads()[0]
    tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    loss, metrics = ts.seq2seq_loss(
        tp, tcfg, _torch_batch(_batch("all")), train=False,
        penalty_scales=SCALES,
    )
    loss.backward()
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            tree_map(lambda t: t.grad, tp))


@pytest.mark.parametrize(
    "head,use_pallas",
    [("categorical", True), ("Gaussian", True), ("Rayleigh", True),
     ("all", False)],
)
def test_seq2seq_loss_and_gradients_match_jax(head, use_pallas):
    """A model with one aux head of each distribution, at train=False:
    each case holds its head's loss and its head's gradient leaves (the
    'all' case, on the step-loop path, every metric and leaf)."""
    _, loss_j, metrics_j, grads_j = _jax_loss_and_grads()
    loss_t, metrics_t, grads_t = _port_loss_and_grads(use_pallas)
    assert sorted(metrics_t) == sorted(metrics_j) == sorted(
        [f"loss_{h}" for h in HEADS]
        + ["loss_decoder", "token_accuracy", "loss_total"]
    )
    if head == "all":
        for k in metrics_j:
            np.testing.assert_allclose(metrics_t[k], float(metrics_j[k]),
                                       err_msg=k, **F32)
        np.testing.assert_allclose(loss_t, float(loss_j), **F32)
        _assert_trees_close(grads_t, grads_j)
    else:
        np.testing.assert_allclose(metrics_t[f"loss_{head}"],
                                   float(metrics_j[f"loss_{head}"]), **F32)
        _assert_trees_close(grads_t["aux"][head], grads_j["aux"][head])
        _assert_trees_close(grads_t["encoder"], grads_j["encoder"])


def test_undeclared_distribution_raises():
    _, tcfg = _configs("Poisson")
    tp = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch("Gaussian"))
    with pytest.raises(ValueError, match="unknown distribution"):
        ts.seq2seq_loss(tp, tcfg, batch, train=False)


def test_dropout_keep_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    x = torch.ones((400, 500))
    for rate in (0.1, 0.5):
        keep = 1.0 - rate
        y = ts._ff_dropout(g, x, rate, train=True)
        m = ts._recurrent_mask(g, 400, 500, rate, torch.device("cpu"))
        assert m.dtype == torch.float32
        for a in (y, m):
            values = torch.unique(a).tolist()
            assert len(values) == 2 and values[0] == 0.0
            assert values[1] == pytest.approx(1.0 / keep)
            assert abs(float((a > 0).float().mean()) - keep) < 0.01
    assert ts._ff_dropout(g, x, 0.5, train=False) is x
    assert ts._ff_dropout(g, x, 0.0, train=True) is x


def test_training_loss_draws_from_the_generator():
    """With dropout on, the same seed gives the same loss and another
    seed another loss; from one seed the kernel and plain paths draw the
    same masks and agree."""
    _, tcfg = _configs("categorical", use_pallas=True, FF_dropout=0.3, RNN_dropout=0.5)
    tp = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch("categorical"))

    def loss(seed, cfg=tcfg):
        g = torch.Generator().manual_seed(seed)
        return float(ts.seq2seq_loss(tp, cfg, batch, g, train=True)[0])

    assert loss(1) == loss(1) != loss(2)
    plain = dataclasses.replace(tcfg, use_pallas_lstm=False)
    np.testing.assert_allclose(loss(1, plain), loss(1), **F32)
    no_dropout = float(ts.seq2seq_loss(tp, tcfg, batch, train=False)[0])
    assert no_dropout != loss(1)


def test_training_without_a_generator_raises():
    """As JAX requires ``rng`` when training, the port requires a
    generator: no silent fixed seed that repeats the masks every step."""
    _, tcfg = _configs("categorical", FF_dropout=0.3, RNN_dropout=0.5)
    tp = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch("categorical"))
    x, lengths = batch["encoder_inputs"], batch["encoder_lengths"]
    for call in (
        lambda: ts.seq2seq_loss(tp, tcfg, batch),
        lambda: ts.encode(tp, tcfg, x, lengths, 0, train=True),
    ):
        with pytest.raises(ValueError, match="needs a torch.Generator"):
            call()


def test_segment_runner_matches_jax():
    """One 4-step segment over two subjects from the same params and
    schedule at dropout 0: mean loss_total, params and EMA after the
    segment (clip, Adam and EMA included).  Adam divides each gradient
    by its running RMS, so an element whose gradient is small against
    its own history moves by a visible fraction of the learning rate on
    summation-order noise alone (seen: one decoder ``wh`` element 2.6e-5
    apart at lr 1e-2); params and EMA get atol 1e-4, lr / 100."""
    jcfg, tcfg = _configs("categorical", use_pallas=True, FF_dropout=0.0,
                          RNN_dropout=0.0, num_subjects=2, rnn_sizes=(8,))
    scales = {"aux": 1.0, "decoder_targets": 1.0}
    lr, decay = 1e-2, 0.9
    jp = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    data = {k: np.stack([v, _batch("categorical", seed=9, n=6)[k]])
            for k, v in _batch("categorical", seed=8, n=6).items()}
    subjects = np.array([0, 1, 1, 0], np.int32)
    idx = np.array([[0, 3, 5], [1, 2, 4], [5, 5, 0], [2, 1, 4]], np.int32)

    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    jstate = jtrain.TrainState(jp, jax.tree.map(jnp.copy, jp), optimizer.init(jp),
                               jnp.asarray(0, jnp.int32))
    jrun = jtrain.make_segment_runner(jcfg, optimizer, scales, decay)
    jstate, jmetrics = jrun(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                            subjects, idx, jax.random.PRNGKey(0), 1)

    tp = params_from_numpy(tree, "cpu")
    tstate = ttrain.TrainState(tp, tree_map(lambda t: t.clone(), tp),
                               ttrain.make_optimizer(tp, lr), 0)
    trun = ttrain.make_segment_runner(tcfg, scales, decay)
    tstate, tmetrics = trun(tstate, {k: torch.from_numpy(v) for k, v in data.items()},
                            subjects, idx, torch.Generator().manual_seed(0), 1)
    assert tstate.epoch == 1
    np.testing.assert_allclose(float(tmetrics["loss_total"]),
                               float(jmetrics["loss_total"]), **F32)
    tol = dict(rtol=1e-4, atol=1e-4)
    _assert_trees_close(tstate.params, jax.tree.map(np.asarray, jstate.params), tol)
    _assert_trees_close(tstate.ema, jax.tree.map(np.asarray, jstate.ema), tol)


def test_clip_by_global_norm_is_optax():
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) * 4, rng.normal(size=7).astype(np.float32)]
    for scale in (1.0, 0.01):
        want = optax.clip_by_global_norm(10.0).update([g * scale for g in grads], None)[0]
        got = [torch.from_numpy(g * scale) for g in grads]
        ttrain.clip_by_global_norm(got, 10.0)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


# --------------------------------------------------------------------------
# the trainer and the data side, on the demo experiment
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_e2e")
    mp = tdemo.make_demo_experiment(
        str(root / "exp"), subject_ids=(1,), layer_sizes=TINY, N_epochs=40
    )
    tr = ttrain.MultiSubjectTrainer(
        mp, [1], SN_kwargs={**SN, "use_pallas_lstm": True}, VERBOSE=False,
        device="cpu",
    )
    tr.history = tr.parallel_transfer_learn()
    return tr


def test_trainer_learns_on_the_demo(trained):
    wers = [snap["training"]["word_error_rate"] for snap in trained.history.values()]
    assert wers[-1] < wers[0] - 0.2, f"no learning: {wers}"
    assert wers[-1] < 0.7
    assert trained.state.epoch == 40 and list(trained.history) == ["10", "20", "30", "40"]
    snap = trained.history["40"]["validation"]
    assert snap["decoder_confusions"].shape[0] == trained.net_config.vocab_size
    assert len(snap["references"]) == len(snap["hypotheses"]) == 10


def test_trainer_results_and_checkpoints(trained):
    results_dir = trained.manifest.resolve("saved_results_dir")
    files = [f for f in os.listdir(results_dir) if f.startswith("accuracies_")]
    lines = open(os.path.join(results_dir, files[0])).read().splitlines()
    assert len(lines) == 4 and lines[-1].split()[-1] == "40"
    assert trained.restore_epoch == 40
    wer = trained.assess(["validation"])["validation"]["word_error_rate"]
    state = trained.state
    trained.state = state._replace(ema=tree_map(lambda t: t * 0.0, state.ema))
    out = trained.assess_saved_model(restore_epoch=40)
    assert out["validation"]["word_error_rate"] == pytest.approx(wer)
    assert trained.state.epoch == 40


def test_predictor_from_trainer(trained):
    predictor = OnlinePredictor.from_trainer(trained)
    assert predictor.device.type == "cpu" and predictor.subject_idx == 0
    val = trained.packed_dataset("validation")
    x = val.encoder_inputs[0, 0, : int(val.encoder_lengths[0, 0])]
    out = predictor(x)
    assert out["tokens"].shape == (1, trained.net_config.max_dec_len)
    assert np.isfinite(out["probabilities"]).all()


@pytest.mark.parametrize("unported", [
    "distributed", "data_parallel", "sequence_parallel", "pipeline_parallel",
    "tensor_parallel", "expert_parallel", "cluster_embedded_words"])
def test_trainer_refuses_what_is_not_ported(trained, unported):
    """What the port's trainer once refused, naming its ROADMAP item, it
    now does: ``cluster_embedded_words`` (Queue 1, item 12) clusters the
    decoder's embedding rows (``tests/test_torch_plotting.py`` holds it to
    JAX's).  Scope masks, schedules,
    lazy shards, summaries and rebuilding from a checkpoint are ported
    (``tests/test_torch_transfer.py``, ``test_torch_trainer_tools.py``,
    ``test_torch_lazy_pipeline.py``), and so are the bootstrap and data,
    sequence, expert, tensor and pipeline parallelism
    (``tests/test_torch_parallel*.py``, ``tests/test_torch_tp_pp*.py``): in
    one process ``data_parallel`` trains on the one-process path, tensor
    parallelism asks for ``torch.distributed``, and sequence, expert and
    pipeline parallelism refuse a model they cannot shard."""
    if unported == "cluster_embedded_words":
        projection, ids, fig = trained.cluster_embedded_words(num_clusters=4, plot=False)
        vocab = trained.net_config.vocab_size
        assert projection.shape == (vocab, 2) and ids.shape == (vocab,) and fig is None
        assert np.isfinite(projection).all() and set(ids.tolist()) <= {0, 1, 2, 3}
        return

    def build(**sn):
        return ttrain.MultiSubjectTrainer(
            trained._manifest_path, [1], SN_kwargs=sn, VERBOSE=False, device="cpu",
        )

    if unported == "tensor_parallel":
        with pytest.raises(RuntimeError, match="make_mesh needs torch.distributed"):
            build(tensor_parallel=2)
    elif unported == "pipeline_parallel":
        with pytest.raises(ValueError, match="requires encoder_type='conformer'"):
            build(pipeline_parallel=2)
    elif unported == "data_parallel":
        assert build(data_parallel=True).mesh is None
    elif unported == "sequence_parallel":
        with pytest.raises(ValueError, match="requires encoder_type='conformer'"):
            build(sequence_parallel=2)
    elif unported == "expert_parallel":
        with pytest.raises(ValueError, match="requires a MoE conformer"):
            build(expert_parallel=2)
    else:  # a world of one process, over TCP on this host
        import torch.distributed as dist

        from ecog2txt_tpu_torch.parallel.launch import free_port

        try:
            trainer = build(data_parallel=True, distributed={
                "coordinator_address": f"127.0.0.1:{free_port()}",
                "num_processes": 1, "process_id": 0})
            assert dist.get_backend() == "gloo"
            assert trainer.mesh.shape == {"data": 1, "model": 1}
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def test_data_side_matches_jax(trained, tmp_path):
    """The JAX package's demo experiment, written beside the port's,
    gives byte-identical records, and both packages pack and schedule
    them into the same arrays."""
    jmp = jdemo.make_demo_experiment(
        str(tmp_path / "exp"), subject_ids=(1,), layer_sizes=TINY, N_epochs=40
    )
    # the JAX trainer's data wiring, without building its network
    manifest = jconfig.load_experiment_manifest(jmp)[1]
    subject = jsubjects.ECoGSubject(manifest, 1)
    subject.set_append_eos("decoder_targets", True)
    for key, seq_type in subject.data_mapping.items():
        if subject.data_manifests[key].is_categorical:
            vocab = jtokenizers.read_vocab_file(manifest[f"{seq_type}_vocab_file"])
            subject.set_feature_list(key, jtokenizers.with_special_tokens(vocab, True))
    subject.write_tf_records_maybe()
    tgen = trained.target_subject.data_generator
    for block in sorted(trained.target_subject.all_blocks):
        with open(tgen.tf_record_path(block), "rb") as a, open(
            subject.data_generator.tf_record_path(block), "rb"
        ) as b:
            assert a.read() == b.read(), block
    for partition in ("training", "validation"):
        tds = trained.packed_dataset(partition)
        jds = jpipeline.pack_partition(
            [subject], partition,
            pad_channels_to=trained.net_config.in_channels,
            pad_time_multiple=trained.net_config.decimation_factor,
        )
        tb, jb = tds.batch_dict(), jds.batch_dict()
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tds.references == jds.references
        want = jpipeline.make_schedule(jds, 16, 3, np.random.default_rng(5))
        got = tpipeline.make_schedule(tds, 16, 3, np.random.default_rng(5))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    refs = [" ".join(r) for r in tds.references[0]]
    hyps = trained.history["40"]["validation"]["hypotheses"]
    np.testing.assert_array_equal(
        tassess.wer_vector(refs, hyps), jassess.wer_vector(refs, hyps)
    )


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.MultiSubjectTrainer("absent.yaml", [1])
