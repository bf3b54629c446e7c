"""The port's trainer tools held to the JAX package at small sizes.

``utils.introspect.recover_model_sizes`` on the port's trees (and its
``ckpt-<epoch>.pt`` files) against JAX's on the same shapes, for both
encoder families and the MoE; architecture recovery by
``assess_saved_model``; the NaN rollback; the TF1 import of the synthetic
reference variables of ``tests/test_tf1_import.py`` into both packages
(a file written by tensorflow too), and of a trained trainer's own
variables (``tf1_variables_from_params``) with a rebuild; the summaries'
event files against JAX's reader, JAX's writer and tensorflow's reader,
and the trainer's curves; ``get_saliencies`` and
``get_internal_activations`` against JAX's with the same weights; and the
inspection tools (``print_tensor_names``, ``subject_to_table``,
``count_all_targets``, ``tf_record_to_numpy_data``,
``restricted_to_trials``, ``cluster_embedded_words``) against JAX's
outputs.  Tolerances: f32 rtol
1e-4 / atol 1e-5.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.demo import make_demo_experiment as jmake_demo
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.models.conformer import ConformerConfig as JConformer
from ecog2txt_tpu.utils import introspect as jintrospect
from ecog2txt_tpu.utils import summaries as jsummaries
from ecog2txt_tpu.utils import tf1_import as jtf1
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    save_checkpoint,
    tree_leaves,
)
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.models.conformer import ConformerConfig
from ecog2txt_tpu_torch.utils import introspect as tintrospect
from ecog2txt_tpu_torch.utils import summaries as tsummaries
from ecog2txt_tpu_torch.utils import tf1_import as ttf1
from test_tf1_import import CONFIG as TF1_CONFIG
from test_tf1_import import _leaf, _tf1_variables
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
TINY = {
    "encoder_embedding": [16],
    "encoder_rnn": [24],
    "encoder_1_projection": [16],
    "decoder_embedding": [12],
    "decoder_rnn": [48],
    "decoder_projection": [],
}
SMALL = {**TINY, "encoder_rnn": [8, 8], "decoder_rnn": [16]}
SN = {"batch_size": 16, "max_dec_len": 10, "learning_rate": 3e-3, "temperature": 0.0,
      "use_pallas_lstm": True}


def _port_config(jcfg):
    """The port's ``Seq2SeqConfig`` of a JAX one."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["aux_heads"] = tuple(ts.AuxHead(*h) for h in jcfg.aux_heads)
    fields["compute_dtype"] = torch.float32
    if jcfg.conformer is not None:
        fields["conformer"] = ConformerConfig(**jcfg.conformer._asdict())
    return ts.Seq2SeqConfig(**fields)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree))


# --------------------------------------------------------------------------
# recover_model_sizes
# --------------------------------------------------------------------------

RECOVER = {
    "lstm": dict(vocab_size=30, num_subjects=2, in_channels=16, conv_sizes=(32,),
                 decimation_factor=12, rnn_sizes=(48, 48), aux_proj_sizes=(24,),
                 aux_heads=(js.AuxHead("encoder_1_targets", "categorical", 22),),
                 dec_embedding_size=24, dec_rnn_sizes=(96,), max_dec_len=10,
                 use_attention=True),
    "conformer_moe": dict(vocab_size=30, num_subjects=1, in_channels=16, conv_sizes=(32,),
                          decimation_factor=4, rnn_sizes=(48,), aux_proj_sizes=(),
                          dec_embedding_size=24, dec_rnn_sizes=(96,), max_dec_len=10,
                          encoder_type="conformer",
                          conformer=JConformer(num_blocks=3, model_dim=64, num_heads=4,
                                               ffn_dim=128, conv_kernel=6, chunk_size=8,
                                               left_context=1, moe_experts=4, moe_topk=2)),
}
RECOVER["conformer_dense"] = dict(
    RECOVER["conformer_moe"],
    conformer=RECOVER["conformer_moe"]["conformer"]._replace(moe_experts=0))


@pytest.mark.parametrize("family", sorted(RECOVER))
def test_recover_model_sizes_matches_jax(family, tmp_path):
    """Shapes are all either side reads: JAX's tree of ``init_seq2seq``'s
    shapes, the port's of zeros of those shapes."""
    jparams = jax.eval_shape(lambda: js.init_seq2seq(jax.random.PRNGKey(0),
                                                     js.Seq2SeqConfig(**RECOVER[family])))
    want = jintrospect.recover_model_sizes(jparams, in_channels=16)
    tparams = params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jparams), "cpu")
    assert tintrospect.recover_model_sizes(tparams, in_channels=16) == want
    path = save_checkpoint(str(tmp_path / "ckpt-3.pt"), tparams)
    assert tintrospect.recover_model_sizes(path, in_channels=16) == want
    assert tintrospect._shape_tree(tparams) == jintrospect._shape_tree(jparams)
    if family == "conformer_dense":
        assert want["conformer"]["moe_experts"] == 0


# --------------------------------------------------------------------------
# the trainer pair: a port trainer and a JAX trainer with the same weights
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A port trainer trained 4 epochs on the demo experiment (TINY,
    greedy assessment, a checkpoint every 2 epochs, the LSTM kernels'
    plain versions), and a JAX trainer on a byte-identical demo experiment
    holding the port's weights."""
    root = tmp_path_factory.mktemp("tools")
    tmp = make_demo_experiment(str(root / "t"), subject_ids=(1,), layer_sizes=TINY,
                               assessment_epoch_interval=2)
    jmp = jmake_demo(str(root / "j"), subject_ids=(1,), layer_sizes=TINY,
                     assessment_epoch_interval=2)
    tr = ttrain.MultiSubjectTrainer(tmp, [1], SN_kwargs=dict(SN, checkpoint_every_assessment=True),
                                    VERBOSE=False, device="cpu")
    # JAX's recurrence through its plain scan: Pallas runs on the CPU only
    # in interpret mode
    jtr = jtrain.MultiSubjectTrainer(jmp, [1], SN_kwargs=dict(SN, use_pallas_lstm=False),
                                     VERBOSE=False)
    tr.history = tr.fit(num_epochs=4)
    jtr.state = jtr.state._replace(params=_jax_tree(tr.state.params),
                                   ema=_jax_tree(tr.state.ema))
    return tr, jtr


def test_assess_saved_model_rebuilds_the_architecture(pair):
    """A trainer built at other widths assesses the checkpoint: its
    ``net_config`` is rebuilt from the tensor shapes, its leaves are the
    checkpoint's and the WER is the source trainer's."""
    tr, _ = pair
    small = ttrain.MultiSubjectTrainer(
        tr._manifest_path, [1], SN_kwargs=dict(SN, layer_sizes=SMALL), VERBOSE=False,
        device="cpu")
    assert small.net_config.rnn_sizes == (8, 8)
    out = small.assess_saved_model(restore_epoch=4, partitions=("training", "validation"))
    assert small.net_config.rnn_sizes == (24,) and small.net_config.dec_rnn_sizes == (48,)
    assert small.net_config == tr.net_config
    for a, b in zip(tree_leaves(small.state.ema), tree_leaves(tr.state.ema)):
        assert torch.equal(a, b)
    for part in ("training", "validation"):
        assert out[part]["word_error_rate"] == tr.history["4"][part]["word_error_rate"]
        assert out[part]["hypotheses"] == tr.history["4"][part]["hypotheses"]


def test_nan_rollback_restores_the_newest_checkpoint(tmp_path):
    """As JAX's ``test_divergence_detection_and_rollback``: a diverged
    segment raises ``FloatingPointError`` naming the restored epoch, after
    the state was put back to the newest checkpoint bit for bit."""
    mp = make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,), layer_sizes=TINY,
                              assessment_epoch_interval=2)
    tr = ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs=dict(SN, checkpoint_every_assessment=True),
                                    VERBOSE=False, device="cpu")
    tr.fit(num_epochs=2, assess=False)  # a good checkpoint at epoch 2
    saved = [t.clone() for t in tree_leaves(tr.state.params) + tree_leaves(tr.state.ema)]
    tr.learning_rate = 1e18
    with pytest.raises(FloatingPointError, match="restored checkpoint at epoch 2"):
        tr.fit(num_epochs=2, assess=False)
    assert tr.state.epoch == 2 and tr.state.opt_state is None
    now = tree_leaves(tr.state.params) + tree_leaves(tr.state.ema)
    assert all(torch.equal(a, b) for a, b in zip(now, saved))
    assert all(bool(torch.isfinite(t).all()) for t in now)


# --------------------------------------------------------------------------
# TF1 import
# --------------------------------------------------------------------------


def _both_imports(variables, tree=None):
    jparams = js.init_seq2seq(jax.random.PRNGKey(0), TF1_CONFIG)
    jema = jax.tree.map(jnp.copy, jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tema = params_from_numpy(jax.tree.map(np.asarray, jema), "cpu")
    want = jtf1.import_tf1_checkpoint(variables, jparams, jema, subject_ids=[1, 4])
    got = ttf1.import_tf1_checkpoint(variables, tparams, tema, subject_ids=[1, 4])
    return want, got, tparams


def test_tf1_import_matches_jax():
    """The synthetic reference variables (``tests/test_tf1_import.py``)
    into both packages: every leaf equal bit for bit, the same report, the
    same recovered sizes, the old trees untouched."""
    variables, expected, _ = _tf1_variables(np.random.default_rng(0), TF1_CONFIG)
    (jp, je, jreport), (tp, te, treport), old = _both_imports(variables)
    assert treport == jreport and len(treport["imported"]) == len(variables) - 2
    for want, got in ((jp, tp), (je, te)):
        want = jax.tree.map(np.asarray, want)
        got = params_to_numpy(got)
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w)
    for path, value in expected:
        leaf = _leaf(tp, path[:-1])[path[-1]] if path[0] == "subnet" else _leaf(tp, path)
        np.testing.assert_array_equal(leaf.numpy(), value)
    assert not torch.equal(old["decoder"]["out"]["w"], tp["decoder"]["out"]["w"])
    assert ttf1.recover_model_sizes(variables) == jtf1.recover_model_sizes(variables)
    with pytest.raises(ValueError, match="shape mismatch"):
        ttf1.import_tf1_checkpoint(
            {"seq2seq/decoder_embedding_30_10_0/weights": np.zeros((7, 7), np.float32)}, old)


def test_tf1_variables_round_trip():
    """``tf1_variables_from_params`` is the import's inverse: the variables
    of a tree (and its EMA) import back to it bit for bit, and JAX's
    importer reads them to the same leaves."""
    jparams = js.init_seq2seq(jax.random.PRNGKey(3), TF1_CONFIG)
    tree = jax.tree.map(np.asarray, jparams)
    tp = params_from_numpy(tree, "cpu")
    te = params_from_numpy(jax.tree.map(lambda a: a * 2, tree), "cpu")
    variables = ttf1.tf1_variables_from_params(tp, TF1_CONFIG.conv_strides, [1, 4], te)
    zero = params_from_numpy(jax.tree.map(np.zeros_like, tree), "cpu")
    params, ema, report = ttf1.import_tf1_checkpoint(variables, zero, zero, subject_ids=[1, 4])
    assert report["skipped"] == [] and len(report["imported"]) == len(variables)
    for a, b in zip(tree_leaves(params) + tree_leaves(ema), tree_leaves(tp) + tree_leaves(te)):
        assert torch.equal(a, b)
    jp, _, _ = jtf1.import_tf1_checkpoint(variables, jax.tree.map(jnp.zeros_like, jparams),
                                          subject_ids=[1, 4])
    for w, g in zip(jax.tree.leaves(jp), jax.tree.leaves(params_to_numpy(params))):
        np.testing.assert_array_equal(g, np.asarray(w))
    bridged = dataclasses.replace(_port_config(TF1_CONFIG), dec_rnn_sizes=(40,))
    with pytest.raises(ValueError, match="no TF1 name"):
        ttf1.tf1_variables_from_params(
            ts.init_seq2seq(bridged, device="cpu"), TF1_CONFIG.conv_strides, [1, 4])


def test_tf1_checkpoint_file_round_trip(tmp_path):
    """A real TF1-format checkpoint written with ``tf.compat.v1.train.Saver``
    read back through the port's ``read_tf1_checkpoint`` and imported."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    variables, expected, _ = _tf1_variables(np.random.default_rng(1), TF1_CONFIG)
    graph = tf1.Graph()
    with graph.as_default():
        tf_vars = {name: tf1.get_variable(f"v{i}", initializer=tf.constant(value))
                   for i, (name, value) in enumerate(variables.items())}
        saver = tf1.train.Saver(var_list=tf_vars)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "model.ckpt"), global_step=200)
    raw = ttf1.read_tf1_checkpoint(prefix)
    assert set(raw) == set(variables)
    for name, value in variables.items():
        np.testing.assert_array_equal(raw[name], value)
    params = params_from_numpy(
        jax.tree.map(np.asarray, js.init_seq2seq(jax.random.PRNGKey(0), TF1_CONFIG)), "cpu")
    new, _, report = ttf1.import_tf1_checkpoint(prefix, params, subject_ids=[1, 4])
    assert len(report["imported"]) == len(variables) - 3  # no ema tree: the shadow skipped
    for path, value in expected:
        leaf = _leaf(new, path[:-1])[path[-1]] if path[0] == "subnet" else _leaf(new, path)
        np.testing.assert_array_equal(leaf.numpy(), value)


def test_trainer_imports_tf1_variables_with_a_rebuild(pair):
    """A trainer built at other widths imports the trained trainer's
    variables (``rebuild='auto'``): ``net_config`` rebuilt, every leaf and
    EMA leaf equal bit for bit, the same assessment; JAX's trainer rebuilds
    to the same layer sizes from the same variables."""
    tr, jtr = pair
    variables = ttf1.tf1_variables_from_params(
        tr.state.params, tr.net_config.conv_strides, tr.subject_ids, tr.state.ema)
    fresh = ttrain.MultiSubjectTrainer(tr._manifest_path, [1], SN_kwargs=dict(SN, layer_sizes=SMALL),
                                       VERBOSE=False, device="cpu")
    report = fresh.import_tf1_checkpoint(variables)
    assert report["skipped"] == []
    assert fresh.net_config == tr.net_config and fresh.state.opt_state is None
    for a, b in zip(tree_leaves(fresh.state.params) + tree_leaves(fresh.state.ema),
                    tree_leaves(tr.state.params) + tree_leaves(tr.state.ema)):
        assert torch.equal(a, b)
    got = fresh.assess(["validation"])["validation"]
    assert got["hypotheses"] == tr.history["4"]["validation"]["hypotheses"]
    jfresh = jtrain.MultiSubjectTrainer(jtr._manifest_path, [1], VERBOSE=False,
                                        SN_kwargs=dict(SN, layer_sizes=SMALL,
                                                       use_pallas_lstm=False))
    jfresh.import_tf1_checkpoint(variables)
    assert jfresh.net_config.rnn_sizes == fresh.net_config.rnn_sizes
    assert jfresh.net_config.dec_rnn_sizes == fresh.net_config.dec_rnn_sizes


# --------------------------------------------------------------------------
# summaries
# --------------------------------------------------------------------------


def _write_events(module, logdir):
    with module.SummaryWriter(logdir) as writer:
        writer.scalar("loss/total", 1.5, step=1)
        writer.scalars({"validation/word_error_rate": 0.25, "validation/accuracy": 0.75},
                       step=10)
        return writer.path


def test_event_files_match_jax_and_tensorflow(tmp_path):
    """The port's event file decodes, by JAX's reader and by its own, to
    JAX's writer's events (wall times aside), and tensorflow reads it."""
    tpath = _write_events(tsummaries, str(tmp_path / "t"))
    jpath = _write_events(jsummaries, str(tmp_path / "j"))
    strip = lambda events: [{k: v for k, v in e.items() if k != "wall_time"}  # noqa: E731
                            for e in events]
    want = strip(jsummaries.iter_events(jpath))
    assert strip(jsummaries.iter_events(tpath)) == want
    assert strip(tsummaries.iter_events(tpath)) == want
    assert want[1]["scalars"] == {"loss/total": 1.5}
    tf = pytest.importorskip("tensorflow")
    events = list(tf.compat.v1.train.summary_iterator(tpath))
    assert events[0].file_version == "brain.Event:2"
    assert [e.step for e in events[1:]] == [1, 10]
    assert {v.tag: v.simple_value for v in events[2].summary.value} == want[2]["scalars"]


def test_trainer_writes_training_curves(pair, tmp_path):
    """``fit`` under ``tf_summaries_dir`` writes the loss and train scalars
    and each partition's WER and accuracy at every assessment epoch; the
    last loss equals the segment's mean loss."""
    tr, _ = pair
    logdir = str(tmp_path / "tb")
    trainer = ttrain.MultiSubjectTrainer(
        tr._manifest_path, [1], SN_kwargs=dict(SN, tf_summaries_dir=logdir), VERBOSE=False,
        device="cpu")
    history = trainer.fit(num_epochs=3)
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    events = [e for e in tsummaries.iter_events(path) if "scalars" in e]
    by_step: dict = {}
    for e in events:
        by_step.setdefault(e["step"], {}).update(e["scalars"])
    assert sorted(by_step) == [int(k) for k in history] == [2, 3]
    for step, scalars in by_step.items():
        assert {"loss/total", "loss/decoder", "loss/encoder_1_targets", "train/token_accuracy",
                "training/word_error_rate", "training/accuracy",
                "validation/word_error_rate", "validation/accuracy"} <= set(scalars)
        snap = history[str(step)]
        assert scalars["validation/word_error_rate"] == pytest.approx(
            snap["validation"]["word_error_rate"], rel=1e-6)
        assert np.isfinite(scalars["loss/total"])


def test_summary_writer_resolution(tmp_path):
    """SN_kwargs over the manifest; an explicit None disables; a directory
    that cannot be made warns once and disables."""
    mp = make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,), layer_sizes=TINY,
                              tf_summaries_dir=str(tmp_path / "tb"))
    off = ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={"tf_summaries_dir": None},
                                     VERBOSE=False, device="cpu")
    assert off.summary_writer is None and not os.path.exists(tmp_path / "tb")
    on = ttrain.MultiSubjectTrainer(mp, [1], VERBOSE=False, device="cpu")
    assert on.summary_writer.logdir == str(tmp_path / "tb")
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    bad = ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={"tf_summaries_dir": str(blocker / "x")},
                                     VERBOSE=False, device="cpu")
    with pytest.warns(UserWarning, match="unusable"):
        assert bad.summary_writer is None
    assert bad.summary_writer is None  # warned once


# --------------------------------------------------------------------------
# analysis hooks and inspection tools, against JAX
# --------------------------------------------------------------------------


def test_saliencies_match_jax(pair):
    tr, jtr = pair
    for key in ("decoder_targets", "encoder_1_targets"):
        got, want = tr.get_saliencies(key), jtr.get_saliencies(key)
        assert got.shape == want.shape == (10, 288, 16)
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_internal_activations_match_jax(pair):
    tr, jtr = pair
    got, want = tr.get_internal_activations(), jtr.get_internal_activations()
    assert sorted(got) == sorted(want)
    assert sorted(got["aux_targets"]) == sorted(want["aux_targets"]) == ["encoder_1_targets"]
    np.testing.assert_array_equal(got["aux_targets"]["encoder_1_targets"],
                                  want["aux_targets"]["encoder_1_targets"])
    for key in ("model_order_inputs", "encoder_lengths"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("convolved_inputs", "encoder_outputs", "final_state_h", "final_state_c"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **F32)
    np.testing.assert_array_equal(tr.get_encoder_embedding(), jtr.get_encoder_embedding())
    for name in ("decoder/embedding", "encoder/rnn/0/bwd/wh"):
        np.testing.assert_array_equal(tr.get_weights_as_numpy_array(name),
                                      jtr.get_weights_as_numpy_array(name))


def test_inspection_tools_match_jax(pair):
    tr, jtr = pair
    assert sorted(tr.print_tensor_names()) == sorted(jtr.print_tensor_names())
    got, want = tr.subject_to_table(), jtr.subject_to_table()
    assert got.equals(want)
    tcount, jcount = tr.count_all_targets(), jtr.count_all_targets()
    assert sorted(tcount) == sorted(jcount) == [1]
    for part, counter in jcount[1].items():
        assert tcount[1][part].length_stats() == counter.length_stats()
    block = sorted(tr.target_subject.all_blocks)[1]
    for b in (block, None):
        tex = list(tr.tf_record_to_numpy_data(block=b))
        jex = list(jtr.tf_record_to_numpy_data(block=b))
        assert len(tex) == len(jex) > 0
        for t, j in zip(tex, jex):
            assert sorted(t) == sorted(j)
            for k in j:
                if isinstance(j[k], list):
                    assert t[k] == j[k]
                else:
                    np.testing.assert_array_equal(t[k], j[k])
    subset = [5, 1, 30, 7]
    tclone, jclone = tr.restricted_to_trials(subset), jtr.restricted_to_trials(subset)
    assert tclone.device == tr.device and tclone.state.epoch == 0
    tds, jds = tclone.packed_dataset("training"), jclone.packed_dataset("training")
    assert int(tds.num_trials[0]) == len(subset)
    for k, v in jds.batch_dict().items():
        np.testing.assert_array_equal(tds.batch_dict()[k], v, err_msg=k)
    assert tds.references == jds.references
    proj, ids, _ = tr.cluster_embedded_words(num_clusters=4, plot=False)
    jproj, jids, _ = jtr.cluster_embedded_words(num_clusters=4, plot=False)
    np.testing.assert_array_equal(proj, jproj)
    np.testing.assert_array_equal(ids, jids)
