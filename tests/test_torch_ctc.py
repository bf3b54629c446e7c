"""The port's CTC module held to the JAX package at small sizes.

``ctc_loss`` (value and gradient against optax's, through the JAX
``ctc_loss``; an unalignable row and labels with repeats included), the
greedy decode, the lexicon trie and word beam search (the C++ search
against the Python oracle, carried against from-scratch), ``build_lexicon``
over the packaged demo vocab, ``seq2seq_loss`` with a CTC head against
``jax.value_and_grad``, and the pipeline's CTC targets against the JAX
package's pack.  Tolerances: f32 rtol 1e-4 / atol 1e-5; tokens and words
exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import config as jconfig
from ecog2txt_tpu import datagen as jdatagen
from ecog2txt_tpu import pipeline as jpipeline
from ecog2txt_tpu import subjects as jsubjects
from ecog2txt_tpu import tokenizers as jtokenizers
from ecog2txt_tpu.models import ctc as jctc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import datagen as tdatagen
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import text_dir
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_leaves
from ecog2txt_tpu_torch.models import ctc as tctc
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)


def _ctc_case(seed=0):
    """(T, B, K+1) logits; rows: full length, a label with repeats, an
    unalignable label (5 labels with a repeat in 4 frames), a short row."""
    rng = np.random.default_rng(seed)
    T, B, K1 = 9, 4, 6
    logits = rng.normal(size=(T, B, K1)).astype(np.float32) * 2.0
    logit_lengths = np.array([9, 8, 4, 6], np.int32)
    labels = np.array(
        [[0, 1, 2, 3, 4], [2, 2, 1, 0, 0], [1, 1, 3, 4, 2], [4, 0, 0, 0, 0]], np.int32
    )
    label_lengths = np.array([5, 3, 5, 1], np.int32)
    return logits, logit_lengths, labels, label_lengths


def _value_and_grad(logits, ll, labels, lab_l, rows):
    """(JAX value, JAX gradient, port value, port gradient) over ``rows``."""
    sl = slice(*rows)
    args = (ll[sl], labels[sl], lab_l[sl])
    want, want_g = jax.value_and_grad(
        lambda x: jctc.ctc_loss(x, *map(jnp.asarray, args))
    )(jnp.asarray(logits[:, sl]))
    x = torch.from_numpy(logits[:, sl]).requires_grad_(True)
    got = tctc.ctc_loss(x, *map(torch.from_numpy, args))
    got.backward()
    return float(want), np.asarray(want_g), float(got.detach()), x.grad.numpy()


def test_ctc_loss_value_and_gradient_match_optax():
    """Values in f32, every row; gradients in f32 for the rows that can be
    aligned.  The unalignable row's loss is ~1e5 (optax's ``log_epsilon``
    stands for log 0), where an f32 ulp is ~0.008: its gradient, a
    posterior from differences of such logs, differs from the exact one
    by ~5e-4 in either package (measured against float64), so that row's
    gradient is held in float64 (``jax.enable_x64``), where
    both compute the same function to the stated tolerance."""
    logits, ll, labels, lab_l = _ctc_case()
    want, _, got, _ = _value_and_grad(logits, ll, labels, lab_l, (0, 4))
    assert np.isfinite(got) and got > 1e3  # the unalignable row dominates
    np.testing.assert_allclose(got, want, **F32)
    for b in range(logits.shape[1]):
        want, want_g, got, got_g = _value_and_grad(logits, ll, labels, lab_l, (b, b + 1))
        np.testing.assert_allclose(got, want, **F32)
        if b != 2:
            np.testing.assert_allclose(got_g, want_g, **F32)
    want, want_g, got, got_g = _value_and_grad(logits, ll, labels, lab_l, (0, 2))
    np.testing.assert_allclose(got_g, want_g, **F32)
    with jax.enable_x64(True):
        want, want_g, got, got_g = _value_and_grad(
            logits.astype(np.float64), ll, labels, lab_l, (2, 3)
        )
    assert want_g.dtype == got_g.dtype == np.float64 and got > 1e4
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got_g, want_g, **F32)


def test_collapse_and_greedy_decode_match_jax():
    for seq in ([1, 1, 2, 2, 2, 1, 3], [], [4, 4, 4]):
        np.testing.assert_array_equal(tctc.collapse_alignment(seq),
                                      jctc.collapse_alignment(seq))
    logits, ll, _, _ = _ctc_case(1)
    want = jctc.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(ll))
    assert tctc.ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(ll)) == want


def _grid(rng, T, K):
    grid = rng.normal(size=(T, K + 1)) * 2.0
    return grid - np.log(np.exp(grid).sum(axis=1, keepdims=True))


def test_trie_and_word_beam_search_match_jax():
    lexicon = {"ab": [0, 1], "ac": [0, 2], "b": [1], "ca": [2, 0]}
    ttrie, jtrie = tctc.LexiconTrie(lexicon), jctc.LexiconTrie(lexicon)
    assert ttrie.root == jtrie.root
    grid = np.full((6, 4), -15.0)
    for t, p in enumerate([0, 1, 3, 1, 3, 3]):
        grid[t, p] = 0.0
    assert tctc.ctc_word_beam_search(grid, ttrie, beam_width=8) == ["ab", "b"]
    rng = np.random.default_rng(3)
    for _ in range(3):
        grid = _grid(rng, 20, 3)
        for native in (False, True):
            t = tctc.CTCWordBeamState(ttrie, 6, use_native=native).advance(grid)
            j = jctc.CTCWordBeamState(jtrie, 6, use_native=False).advance(grid)
            assert t.best() == j.best()
            assert t.best_score() == pytest.approx(j.best_score(), abs=1e-9)


def test_native_beam_is_built_from_the_repository_source():
    lib = tctc._load_native()
    assert lib is not None, "g++ should build native/ctcbeam.cpp"
    assert os.path.dirname(tctc._NATIVE_DIR).endswith("ecog2txt_tpu_torch")
    assert os.path.exists(os.path.join(tctc._NATIVE_DIR, "libctcbeam.so"))
    assert tctc._NATIVE_SRC.endswith(os.path.join("native", "ctcbeam.cpp"))
    # ids past the packed key fields: the Python search takes over
    trie = tctc.LexiconTrie({"big": [600, 601], "units": [602]})
    auto = tctc.CTCWordBeamState(trie, beam_width=4)
    assert auto._h is None and trie._native is False
    with pytest.raises(RuntimeError):
        tctc.CTCWordBeamState(trie, beam_width=4, use_native=True)
    grid = np.full((3, 604), -12.0)
    for t, p in enumerate([600, 601, 603]):
        grid[t, p] = 0.0
    assert auto.advance(grid).best() == ["big"]


def test_native_beam_matches_python_oracle_and_carries():
    """Unambiguous lexicon (distinct phoneme triples): the C++ search and
    the Python oracle agree on words and score; a carried state advanced
    over ragged chunks equals the one-shot search at every prefix."""
    rng = np.random.default_rng(7)
    K = 8
    triples = set()
    while len(triples) < 40:
        triples.add(tuple(int(p) for p in rng.integers(0, K, 3)))
    trie = tctc.LexiconTrie({f"w{i:03d}": list(t) for i, t in enumerate(sorted(triples))})
    for _ in range(3):
        T = int(rng.integers(15, 40))
        grid = _grid(rng, T, K)
        py = tctc.CTCWordBeamState(trie, 12, use_native=False).advance(grid)
        nat = tctc.CTCWordBeamState(trie, 12, use_native=True).advance(grid)
        assert py.best() == nat.best()
        assert py.best_score() == pytest.approx(nat.best_score(), abs=1e-9)
        for native in (False, True):
            state = tctc.CTCWordBeamState(trie, 12, use_native=native)
            pos = 0
            while pos < T:
                step = int(rng.integers(1, 8))
                state.advance(grid[pos: pos + step])
                pos = min(pos + step, T)
                oracle = tctc.CTCWordBeamState(trie, 12, use_native=native).advance(grid[:pos])
                assert state.best() == oracle.best() and state.num_steps == pos


def test_build_lexicon_over_the_demo_vocab_matches_jax():
    with open(os.path.join(text_dir, "vocab.demo.36")) as f:
        words = [w.strip() for w in f]
    with open(os.path.join(text_dir, "vocab.demo-phonemes.20")) as f:
        phonemes = [p.strip() for p in f]
    got = tctc.build_lexicon(words, tdatagen.word_to_phonemes, phonemes)
    want = jctc.build_lexicon(words, jdatagen.word_to_phonemes, phonemes)
    assert got == want and len(got) > 20


def test_seq2seq_loss_with_a_ctc_head_matches_jax():
    kw = dict(vocab_size=12, num_subjects=1, in_channels=8, conv_sizes=(16,),
              decimation_factor=4, rnn_sizes=(24,), aux_proj_sizes=(16,),
              dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6)
    jcfg = js.Seq2SeqConfig(**kw, aux_heads=(js.AuxHead("ph", "CTC", 11),))
    tcfg = ts.Seq2SeqConfig(**kw, aux_heads=(ts.AuxHead("ph", "CTC", 11),),
                            use_pallas_lstm=True)
    jparams = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    batch = {
        "encoder_inputs": rng.normal(size=(3, 32, 8)).astype(np.float32),
        "encoder_lengths": np.array([32, 20, 12], np.int32),
        "decoder_targets": rng.integers(2, 12, size=(3, 5)).astype(np.int32),
        "decoder_lengths": np.array([5, 3, 4], np.int32),
        # every row can be aligned (see test_ctc_loss_value_and_gradient_
        # match_optax for the unalignable one's f32 gradient)
        "ph": rng.integers(0, 10, size=(3, 6)).astype(np.int32),
        "ph_lengths": np.array([6, 4, 1], np.int32),
    }

    def jloss(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["subject_idx"] = jnp.asarray(0, jnp.int32)
        return js.seq2seq_loss(p, jcfg, jb, jax.random.PRNGKey(1), False)

    (want, want_m), want_g = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tparams = params_from_numpy(tree, device="cpu")
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["subject_idx"] = 0
    got, got_m = ts.seq2seq_loss(tparams, tcfg, tb, train=False)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(float(got_m["loss_ph"].detach()), float(want_m["loss_ph"]), **F32)
    for g, w in zip(tree_leaves(tparams), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **F32)


def test_pipeline_ctc_targets_match_the_jax_pack(tmp_path):
    """The demo experiment with CTC phoneme targets: the port's trainer
    packs collapsed label sequences and ``<name>_lengths`` exactly as the
    JAX package's ``pack_partition`` does, and one epoch trains through
    the CTC head."""
    sizes = {"encoder_embedding": [16], "encoder_rnn": [24], "encoder_1_projection": [16],
             "decoder_embedding": [12], "decoder_rnn": [48], "decoder_projection": []}
    mp = tdemo.make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,),
                                    layer_sizes=sizes, phoneme_sequence_distribution="CTC")
    tr = ttrain.MultiSubjectTrainer(mp, [1], VERBOSE=False, device="cpu",
                                    SN_kwargs={"batch_size": 16, "max_dec_len": 8})
    head = [h for h in tr.net_config.aux_heads if h.name == "encoder_1_targets"][0]
    assert head.distribution == "CTC"
    manifest = jconfig.load_experiment_manifest(mp)[1]
    subject = jsubjects.ECoGSubject(manifest, 1)
    subject.set_append_eos("decoder_targets", True)
    for key, seq_type in subject.data_mapping.items():
        if subject.data_manifests[key].is_categorical:
            vocab = jtokenizers.read_vocab_file(manifest[f"{seq_type}_vocab_file"])
            subject.set_feature_list(key, jtokenizers.with_special_tokens(vocab, True))
    subject.write_tf_records_maybe()
    for partition in ("training", "validation"):
        tds = tr.packed_dataset(partition)
        jds = jpipeline.pack_partition(
            [subject], partition, pad_channels_to=tr.net_config.in_channels,
            pad_time_multiple=tr.net_config.decimation_factor,
        )
        tb, jb = tds.batch_dict(), jds.batch_dict()
        assert "encoder_1_targets_lengths" in tb and sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["encoder_1_targets"].shape[2] < tb["encoder_inputs"].shape[2]
    history = tr.fit(num_epochs=1, assess=False)
    assert tr.state.epoch == 1 and history == {}
