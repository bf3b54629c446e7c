"""The port's user entry points (``ecog2txt_tpu_torch/examples/``,
``run_demo``) held to the JAX scripts in ``examples/`` and to the JAX
package, on the CPU at narrow widths.

Each example's ``main([..., "--device", "cpu", "--epochs", "1"])`` runs
with its own checks (the raw-voltage WER bound fires at one epoch, as it
must).  Against JAX:
* ``run_mocha_scale``: the JAX script, imported by path and unedited,
  calls ``make_demo_experiment`` and ``MultiSubjectTrainer`` with the same
  arguments as the port's ``build``; both are cut to a small grid and
  narrow layers (dropout 0) the same way, and then the configs, the packed
  training data and, from the JAX trainer's parameters, the first
  segment's loss agree (f32 rtol 1e-4 / atol 1e-5);
* the streamed per-sentence tokens and the pool's tokens equal the JAX
  session's and pool's on the port's trained weights;
* the raw-voltage ``.npz`` trials equal the JAX script's, trial for trial;
* ``migrate_from_reference`` rebuilds, from a TF1 checkpoint file, the
  architecture the JAX package reads from that file, and its exported
  program's tokens equal the predictor's;
* ``moe_expert_parallel`` on 2 gloo ranks (experts split over them)
  equals one process: the same WERs and tokens, parameters within rtol
  1e-4 / atol 1e-4 (``tests/test_torch_parallel_dist.py``'s tolerance for
  parameters after Adam steps);
* ``run_demo``'s electrode contributions equal JAX's
  ``elec_contribs("weight_norms")`` on the same weights.
"""

import dataclasses
import glob
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ecog2txt_tpu.demo as jdemo
import ecog2txt_tpu.train as jtrain
from ecog2txt_tpu import pipeline as jpipeline
from ecog2txt_tpu import serve as jserve
from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.plotting import ResultsPlotter as JResultsPlotter
from ecog2txt_tpu.utils import tf1_import as jtf1
from ecog2txt_tpu_torch import pipeline as tpipeline
from ecog2txt_tpu_torch import run_demo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import load_checkpoint, params_from_numpy, params_to_numpy, tree_map
from ecog2txt_tpu_torch.examples import (
    migrate_from_reference,
    moe_expert_parallel,
    raw_voltage_demo,
    run_mocha_scale,
    serve_pool,
    stream_long_recording,
)
from ecog2txt_tpu_torch.models.seq2seq import init_seq2seq
from ecog2txt_tpu_torch.parallel.launch import spawn
from ecog2txt_tpu_torch.utils.tf1_import import (
    read_tf1_checkpoint,
    recover_model_sizes,
    tf1_variables_from_params,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=1e-5)
CPU = ["--device", "cpu", "--epochs", "1"]
SMALL = {"encoder_embedding": [16], "encoder_rnn": [16, 16], "encoder_1_projection": [16],
         "decoder_embedding": [16], "decoder_rnn": [16], "decoder_projection": []}
CONFORMER = dict(num_blocks=1, model_dim=16, num_heads=2, ffn_dim=32, conv_kernel=4,
                 chunk_size=4, left_context=1)
# the mocha experiment cut for the CPU, the same way on both sides
MOCHA_CUT = dict(grid_size=(4, 4), num_unique_sentences=6, num_sentences_per_block=6,
                 num_training_blocks=2, layer_sizes=SMALL, FF_dropout=0.0, RNN_dropout=0.0)


class _Stop(Exception):
    """Raised by a patched call to stop a JAX script where the test has what
    it needs; carries the object it stopped at."""


def _jax_script(name: str):
    """``examples/<name>.py`` imported by path, as it is."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_config(cfg):
    """The port's ``Seq2SeqConfig`` as the JAX package's (same fields)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["compute_dtype"] = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[
        cfg.compute_dtype]
    kw["aux_heads"] = tuple(js.AuxHead(*h) for h in cfg.aux_heads)
    if cfg.conformer is not None:
        kw["conformer"] = jc.ConformerConfig(**dataclasses.asdict(cfg.conformer))
    return js.Seq2SeqConfig(**kw)


def _assert_same_config(jcfg, tcfg):
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "compute_dtype":
            got, want = str(got).split(".")[-1], jnp.dtype(want).name
        elif f.name == "conformer" and got is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        elif f.name == "aux_heads":
            got, want = [tuple(h) for h in got], [tuple(h) for h in want]
        assert got == want, f"{f.name}: port {got!r}, JAX {want!r}"


def _jax_params(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree))


@pytest.mark.parametrize("module", [run_mocha_scale, stream_long_recording, serve_pool,
                                    raw_voltage_demo, moe_expert_parallel,
                                    migrate_from_reference, run_demo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_default_to_the_card(module, tmp_path):
    """Without ``--device`` an example runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([str(tmp_path)])


# --------------------------------------------------------------------------
# run_mocha_scale
# --------------------------------------------------------------------------


def test_run_mocha_scale_runs(tmp_path, capsys):
    out = run_mocha_scale.main([str(tmp_path), *CPU], grid_size=(4, 4), num_unique_sentences=6,
                               num_sentences_per_block=6, num_training_blocks=2,
                               layer_sizes=SMALL)
    trainer = out["trainer"]
    assert trainer.net_config.use_pallas_lstm is True
    assert trainer.net_config.compute_dtype == torch.bfloat16
    assert list(out["history"]) == ["1"] and out["steps"] == 1  # 12 trials, B=128
    assert all(np.isfinite(w) for w in out["wers"].values()) and out["step_ms"] > 0
    assert "1 epochs + 1 assessments" in capsys.readouterr().out


def _recording(original, seen: list):
    def make(root, **kwargs):
        seen.append(dict(kwargs))
        return original(root, **{**kwargs, **MOCHA_CUT})
    return make


def test_run_mocha_scale_matches_jax_script(tmp_path, monkeypatch):
    jax_script = _jax_script("run_mocha_scale")
    assert jax_script.REFERENCE_LAYERS == run_mocha_scale.REFERENCE_LAYERS
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jdemo, "make_demo_experiment",
                        _recording(jdemo.make_demo_experiment, jax_seen))
    monkeypatch.setattr(run_mocha_scale, "make_demo_experiment",
                        _recording(run_mocha_scale.make_demo_experiment, port_seen))

    def stop(self, *a, **k):
        raise _Stop(self)

    monkeypatch.setattr(jtrain.MultiSubjectTrainer, "parallel_transfer_learn", stop)
    with pytest.raises(_Stop) as stopped:
        jax_script.main([str(tmp_path / "jax"), "--no-pallas"])
    jtr = stopped.value.args[0]
    ttr = run_mocha_scale.build(str(tmp_path / "port"), no_pallas=True, device="cpu")
    # the same construction: experiment arguments, trainer keys, config
    assert jax_seen == port_seen and len(port_seen) == 1
    assert port_seen[0]["grid_size"] == (16, 16) and port_seen[0]["num_training_blocks"] == 9
    assert ttr.SN_kwargs == jtr.SN_kwargs
    _assert_same_config(jtr.net_config, ttr.net_config)
    # the same packed training data
    jds, tds = jtr.packed_dataset("training"), ttr.packed_dataset("training")
    for key in ("encoder_inputs", "encoder_lengths", "decoder_targets", "num_trials"):
        np.testing.assert_array_equal(getattr(tds, key), getattr(jds, key), err_msg=key)
    # the first segment from the JAX trainer's parameters: the same loss
    subjects, idx = jpipeline.make_schedule(jds, jtr.batch_size, 1, np.random.default_rng(0))
    t_subjects, t_idx = tpipeline.make_schedule(tds, ttr.batch_size, 1, np.random.default_rng(0))
    np.testing.assert_array_equal(t_idx, idx)
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(jtr.learning_rate))
    jp = jtr.state.params
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")  # the JAX step donates jp
    jstate = jtrain.TrainState(jp, jax.tree.map(jnp.copy, jp), optimizer.init(jp),
                               jnp.asarray(0, jnp.int32))
    jrun = jtrain.make_segment_runner(jtr.net_config, optimizer, jtr.penalty_scales,
                                      jtr.EMA_decay)
    _, jm = jrun(jstate, jtr.device_data("training"), subjects, idx, jax.random.PRNGKey(0), 1)
    tstate = ttrain.TrainState(tp, tree_map(lambda t: t.clone(), tp),
                               ttrain.make_optimizer(tp, ttr.learning_rate), 0)
    trun = ttrain.make_segment_runner(ttr.net_config, ttr.penalty_scales, ttr.EMA_decay)
    _, tm = trun(tstate, ttr.device_data("training"), t_subjects, t_idx,
                 torch.Generator().manual_seed(0), 1)
    np.testing.assert_allclose(float(tm["loss_total"]), float(jm["loss_total"]), **F32)


# --------------------------------------------------------------------------
# the conformer session and pool
# --------------------------------------------------------------------------


def test_stream_long_recording_equals_jax_session(tmp_path, capsys):
    out = stream_long_recording.main([str(tmp_path), *CPU, "--sentences", "3", "--ctc"],
                                     SN_kwargs={"conformer": CONFORMER}, layer_sizes=SMALL)
    assert out["matches"] == 3 and all(s["exact"] for s in out["sentences"])
    assert "streamed == offline for 3/3" in capsys.readouterr().out
    trainer = out["trainer"]
    manifests = trainer.target_subject.data_manifests
    session = jserve.StreamingConformerSession(
        _jax_params(trainer.full_params()), _jax_config(trainer.net_config),
        manifests["decoder_targets"].feature_list, subject_idx=0,
        phoneme_list=manifests["encoder_1_targets"].feature_list,
    )
    ds = trainer.packed_dataset("validation")
    for i, sentence in enumerate(out["sentences"]):
        raw = np.asarray(ds.encoder_inputs[0][i][: int(ds.encoder_lengths[0][i])], np.float32)
        for start in range(0, len(raw), 57):
            session.push(raw[start: start + 57])
        np.testing.assert_array_equal(sentence["tokens"],
                                      np.asarray(session.endpoint()["tokens"])[0])


def test_serve_pool_equals_jax_pool(tmp_path, capsys):
    out = serve_pool.main([str(tmp_path), *CPU], SN_kwargs={"conformer": CONFORMER},
                          layer_sizes=SMALL)
    assert len(out["streams"]) == 3 and all(s["agree"] for s in out["streams"])
    assert "3/3 streams: pooled == dedicated == offline" in capsys.readouterr().out
    trainer = out["trainer"]
    params, cfg = _jax_params(trainer.full_params()), _jax_config(trainer.net_config)
    targets = trainer.target_subject.data_manifests["decoder_targets"].feature_list
    ds = trainer.packed_dataset("validation")
    utts = [np.asarray(ds.encoder_inputs[0, i, : int(ds.encoder_lengths[0, i])], np.float32)
            for i in range(3)]
    pool = jserve.StreamingSessionPool(params, cfg, targets, capacity=3)
    sessions = [jserve.StreamingConformerSession(params, cfg, targets) for _ in range(3)]
    slots = serve_pool.play(pool, sessions, utts)
    for i, stream in enumerate(out["streams"]):
        np.testing.assert_array_equal(stream["tokens"],
                                      np.asarray(pool.endpoint(slots[i])["tokens"])[0])


# --------------------------------------------------------------------------
# raw voltage
# --------------------------------------------------------------------------


def test_raw_voltage_demo_trials_equal_jax_script(tmp_path, monkeypatch):
    with pytest.raises(AssertionError, match="raw-voltage training failed to learn: WER"):
        raw_voltage_demo.main([str(tmp_path / "port"), *CPU],
                              experiment=dict(layer_sizes=SMALL))
    original = jdemo.make_demo_experiment

    def make(root, **kwargs):
        if kwargs.get("DataGenerator") == "ArrayDataGenerator":
            raise _Stop(kwargs)
        return original(root, **kwargs)

    monkeypatch.setattr(jdemo, "make_demo_experiment", make)
    monkeypatch.setattr(sys, "argv", ["raw_voltage_demo.py", str(tmp_path / "jax")])
    with pytest.raises(_Stop) as stopped:
        _jax_script("raw_voltage_demo").main()
    assert stopped.value.args[0]["high_gamma"] == raw_voltage_demo.HG
    assert stopped.value.args[0]["raw_sampling_rate"] == raw_voltage_demo.RAW_RATE
    names = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "raw_trials" / "*" / "*.npz")))
    assert len(names) == 60
    assert names == sorted(os.path.relpath(p, tmp_path / "port")
                           for p in glob.glob(str(tmp_path / "port" / "raw_trials" / "*" / "*.npz")))
    for name in names:
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name}: {key}")


def test_raw_voltage_streamed_featurization_equals_offline(tmp_path):
    _, cfg, gen, rng, n = raw_voltage_demo.write_raw_trials(str(tmp_path), "cpu")
    err, frames = raw_voltage_demo.streamed_vs_offline(cfg, gen, rng, "cpu")
    assert n == 60 and frames > 100
    assert err < 1e-3


# --------------------------------------------------------------------------
# MoE over ranks
# --------------------------------------------------------------------------


def test_moe_expert_parallel_over_two_ranks_equals_one_process(tmp_path, capsys):
    one = moe_expert_parallel.main([str(tmp_path / "one"), *CPU], layer_sizes=SMALL)
    assert one["mesh"] is None and "streamed == offline" in capsys.readouterr().out
    ranks = spawn("ecog2txt_tpu_torch.examples.moe_expert_parallel:main", 2,
                  {"argv": [str(tmp_path / "ranks"), *CPU], "layer_sizes": SMALL,
                   "SN_kwargs": {"data_parallel": True, "expert_parallel": 2}},
                  timeout=300, backend="gloo", device="cpu", pythonpath=[REPO],
                  env={"OMP_NUM_THREADS": "1"})
    for r in ranks:
        assert r["mesh"] == {"data": 1, "model": 2}
        assert r["history"] == one["history"]
        np.testing.assert_array_equal(r["tokens"], one["tokens"])
        np.testing.assert_array_equal(r["tokens"], r["offline"])
        for got, want in zip(jax.tree.leaves(r["params"]), jax.tree.leaves(one["params"])):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# migration from the reference
# --------------------------------------------------------------------------


def test_migrate_rebuilds_as_jax_reads_the_same_tf1_file(tmp_path):
    import tensorflow as tf

    # a complete TF1 checkpoint of another architecture than the manifest's
    base = migrate_from_reference.build(str(tmp_path / "base"), device="cpu").net_config
    # (a biLSTM of 2 x 24 into a decoder of 48: no bridge, which has no TF1 name)
    source = dataclasses.replace(base, conv_sizes=(20,), rnn_sizes=(24,), dec_rnn_sizes=(48,),
                                 dec_embedding_size=12, aux_proj_sizes=(8,))
    params = init_seq2seq(source, torch.Generator().manual_seed(1), device="cpu")
    variables = tf1_variables_from_params(params, source.conv_strides, [1], params)
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        saver = tf1.train.Saver(var_list={
            name: tf1.get_variable(f"v{i}", initializer=tf.constant(value))
            for i, (name, value) in enumerate(variables.items())})
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "tf1" / "model.ckpt"), global_step=200)

    out = migrate_from_reference.main([str(tmp_path / "port"), *CPU, "--tf1-ckpt", prefix])
    assert out["report"]["skipped"] == [] and len(out["report"]["imported"]) == len(variables)
    assert out["recovered"] == recover_model_sizes(variables)
    ttr = out["trainer"]
    assert (ttr.net_config.rnn_sizes, ttr.net_config.dec_rnn_sizes) == ((24,), (48,))
    np.testing.assert_array_equal(out["exported_tokens"], out["tokens"])

    # the JAX package reads the same architecture from the same file
    want = jtf1.recover_model_sizes(prefix)
    assert out["recovered"] == want
    cfg, sizes = ttr.net_config, want["layer_sizes"]
    assert (list(cfg.conv_sizes), list(cfg.rnn_sizes), list(cfg.aux_proj_sizes),
            [cfg.dec_embedding_size], list(cfg.dec_rnn_sizes), cfg.vocab_size) == (
        sizes["encoder_embedding"], sizes["encoder_rnn"], sizes["encoder_1_projection"],
        sizes["decoder_embedding"], sizes["decoder_rnn"], want["vocab_size"])


def test_migrate_standin_sources(tmp_path, monkeypatch):
    """Without ``--tf1-ckpt``: with tensorflow, the one-variable TF1 file the
    JAX script writes; without it (as on the card's machine), the trainer's
    parameters and EMA as a complete mapping of the reference's variables
    (the bridge left out), which imports whole into the same architecture."""
    trainer = migrate_from_reference.build(str(tmp_path), device="cpu")
    path, what = migrate_from_reference.standin_tf1_source(trainer, str(tmp_path))
    assert what.startswith("stand-in: a TF1 checkpoint file") and path.endswith("ckpt-200")
    assert list(read_tf1_checkpoint(path)) == ["seq2seq/decoder_projection_96_39_0/weights"]
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    variables, what = migrate_from_reference.standin_tf1_source(trainer, str(tmp_path))
    assert "tensorflow is not installed" in what
    assert "bridge_h" in trainer.state.params["decoder"]
    sizes = recover_model_sizes(variables)["layer_sizes"]
    assert (sizes["encoder_rnn"], sizes["decoder_rnn"]) == ([64, 64], [96])
    before = trainer.net_config
    report = trainer.import_tf1_checkpoint(variables)
    assert report["skipped"] == [] and len(report["imported"]) == len(variables)
    assert trainer.net_config == before


# --------------------------------------------------------------------------
# the demo's analysis step
# --------------------------------------------------------------------------


def test_run_demo_contributions_equal_jax(tmp_path):
    out = run_demo.main([str(tmp_path), *CPU])
    ckpt = sorted(glob.glob(str(tmp_path / "exp" / "checkpoints" / "1" / "*")))[-1]
    ema = load_checkpoint(ckpt, device="cpu")["ema"]
    jtr = jtrain.MultiSubjectTrainer(str(tmp_path / "exp" / "demo_word_sequence.yaml"), [1],
                                     VERBOSE=False)
    jtr.state = jtr.state._replace(ema=_jax_params(ema))
    want = JResultsPlotter(jtr.target_subject, jtr, VERBOSE=False).elec_contribs("weight_norms")
    assert out["elec_contribs"].shape == want.shape == (16,)
    np.testing.assert_allclose(out["elec_contribs"], want, **F32)
