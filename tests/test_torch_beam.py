"""The port's beam search held to the JAX package's ``beam_decode``.

The same weights (``convert.params_from_numpy``) and seeded inputs go
through both: every beam's tokens exact and its length-normalised score at
f32 rtol 1e-4 / atol 1e-5, with and without Luong attention, with a
temperature, under each ``use_pallas_lstm`` (the kernels' plain versions
on the CPU); ``beam_width=1`` equals the greedy decode; no token follows
EOS; and the trainer's assessment decodes by beam search when
``beam_width`` > 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.models import beam as jbeam
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy
from ecog2txt_tpu_torch.models import beam as tbeam
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.tokenizers import target_inds_to_sequences
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
KW = dict(vocab_size=10, num_subjects=1, in_channels=6, conv_sizes=(12,),
          decimation_factor=4, rnn_sizes=(16,), aux_proj_sizes=(8,),
          dec_embedding_size=8, dec_rnn_sizes=(32,), max_dec_len=6)
LENGTHS = np.array([24, 16, 20], np.int32)


def _setup(use_attention=False, seed=0):
    jcfg = js.Seq2SeqConfig(**KW, use_attention=use_attention)
    jparams = js.init_seq2seq(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    inputs = np.random.default_rng(seed).normal(size=(3, 24, 6)).astype(np.float32)
    return jcfg, jparams, tree, inputs


def _jax_beam(jcfg, jparams, inputs, **kw):
    hyps, scores = jbeam.beam_decode(
        jparams, jcfg, jnp.asarray(inputs), jnp.asarray(LENGTHS),
        jnp.asarray(0, jnp.int32), return_all=True, **kw,
    )
    return np.asarray(hyps), np.asarray(scores)


def _port_beam(tree, inputs, use_pallas=False, use_attention=False, **kw):
    tcfg = ts.Seq2SeqConfig(**KW, use_attention=use_attention, use_pallas_lstm=use_pallas)
    params = params_from_numpy(tree, device="cpu")
    with torch.inference_mode():
        hyps, scores = tbeam.beam_decode(
            params, tcfg, torch.from_numpy(inputs), torch.from_numpy(LENGTHS), 0,
            return_all=True, **kw,
        )
    return hyps.numpy(), scores.numpy()


@pytest.mark.parametrize("use_pallas", [False, True, "bi_grid"])
@pytest.mark.parametrize("variant", ["plain", "attention", "temperature"])
def test_beam_decode_matches_jax(variant, use_pallas):
    attn = variant == "attention"
    kw = dict(beam_width=4, alpha=0.6)
    if variant == "temperature":
        kw.update(temperature=0.7, alpha=1.0)
    jcfg, jparams, tree, inputs = _setup(attn, seed=1 if attn else 0)
    want_h, want_s = _jax_beam(jcfg, jparams, inputs, **kw)
    got_h, got_s = _port_beam(tree, inputs, use_pallas, attn, **kw)
    assert got_h.shape == (3, 4, KW["max_dec_len"]) and got_h.dtype == np.int32
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_allclose(got_s, want_s, **F32)
    assert (np.diff(got_s, axis=1) <= 1e-6).all()  # best-first


def test_beam_width_1_is_greedy_and_pads_after_eos():
    jcfg, jparams, tree, inputs = _setup()
    tcfg = ts.Seq2SeqConfig(**KW)
    params = params_from_numpy(tree, device="cpu")
    args = (torch.from_numpy(inputs), torch.from_numpy(LENGTHS), 0)
    with torch.inference_mode():
        greedy = ts.greedy_decode(params, tcfg, *args, temperature=0.0)
        beam1 = tbeam.beam_decode(params, tcfg, *args, beam_width=1, alpha=0.0)
        best = tbeam.beam_decode(params, tcfg, *args, beam_width=3)
    np.testing.assert_array_equal(beam1.numpy(), greedy.numpy())
    want = jbeam.beam_decode(jparams, jcfg, jnp.asarray(inputs), jnp.asarray(LENGTHS),
                             jnp.asarray(0, jnp.int32), beam_width=3)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want))
    for row in best.numpy():
        eos = np.where(row == tcfg.eos_id)[0]
        if len(eos):
            assert (row[eos[0] + 1:] == tcfg.pad_id).all()


def test_assess_decodes_by_beam_search(tmp_path):
    """``beam_width`` > 1 in the trainer's assessment runs ``beam_decode``
    (it raised before the port had it)."""
    sizes = {"encoder_embedding": [16], "encoder_rnn": [24], "encoder_1_projection": [16],
             "decoder_embedding": [12], "decoder_rnn": [48], "decoder_projection": []}
    mp = tdemo.make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,), layer_sizes=sizes)
    tr = ttrain.MultiSubjectTrainer(
        mp, [1], VERBOSE=False, device="cpu",
        SN_kwargs={"batch_size": 16, "max_dec_len": 8, "beam_width": 3, "temperature": 0.0},
    )
    assert tr.beam_width == 3
    out = tr.assess(["validation"])["validation"]
    dev = tr.device_data("validation")
    n = int(tr.packed_dataset("validation").num_trials[0])
    with torch.inference_mode():
        tokens = tbeam.beam_decode(tr.state.ema, tr.net_config, dev["encoder_inputs"][0],
                                   dev["encoder_lengths"][0], 0, beam_width=3)
    dec_list = tr.target_subject.data_manifests["decoder_targets"].feature_list
    assert out["hypotheses"] == target_inds_to_sequences(tokens.numpy()[:n], dec_list)
    assert 0.0 <= out["word_error_rate"] and len(out["references"]) == n
