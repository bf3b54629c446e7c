"""The port's demo twin and its decode-quality orderings.

``python -m ecog2txt_tpu_torch.run_demo`` (``run_demo.main``) on the CPU:
a 2-epoch run end to end (experiment, training, assessment of the
validation and testing blocks, an online prediction).  Marked ``slow`` as
the JAX package marks its own (``tests/test_decode_quality.py``): the
default 100-epoch demo reaches WER 0 on both partitions; at the
calibrated nonzero-WER operating point greedy sits in (0, 0.3], beam 8 is
no worse, and the CTC head's lexicon rescoring gives usable words; a
donor-pretrained target beats the cold one at the same epoch budget (the
orderings the JAX test pins).
"""

import numpy as np
import pytest
import torch

from ecog2txt_tpu_torch import run_demo
from ecog2txt_tpu_torch.assess import wer_vector
from ecog2txt_tpu_torch.datagen import word_to_phonemes
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.models.ctc import CTCWordBeamState, LexiconTrie, collapse_alignment
from ecog2txt_tpu_torch.models.seq2seq import encode
from ecog2txt_tpu_torch.serve import _ctc_head_apply
from ecog2txt_tpu_torch.train import MultiSubjectTrainer
from torch_threads import one_torch_thread  # noqa: F401

OP_POINT = dict(synth_pattern_correlation=0.35, synth_noise_scale=0.15,
                num_unique_sentences=12, num_sentences_per_block=12, num_training_blocks=3)


def test_demo_twin_runs_end_to_end(tmp_path, capsys):
    out = run_demo.main([str(tmp_path), "--epochs", "2", "--device", "cpu"])
    assert set(out) == {"validation", "testing", "elec_contribs"}
    for partition in ("validation", "testing"):
        snap = out[partition]
        assert np.isfinite(snap["word_error_rate"]) and len(snap["hypotheses"]) > 0
    assert out["elec_contribs"].shape == (16,) and np.isfinite(out["elec_contribs"]).all()
    printed = capsys.readouterr().out
    assert "validation: WER" in printed and "online predict:" in printed
    assert "electrode contributions (weight norms):" in printed
    assert (tmp_path / "exp" / "demo_word_sequence.yaml").is_file()


@pytest.mark.slow
def test_demo_twin_reaches_wer_zero(tmp_path):
    out = run_demo.main([str(tmp_path), "--device", "cpu"])
    assert out["validation"]["word_error_rate"] == 0.0
    assert out["testing"]["word_error_rate"] == 0.0


def _make_trainer(root, subject_ids=(1,)):
    mp = make_demo_experiment(str(root), subject_ids=subject_ids, grid_size=(4, 4),
                              phoneme_sequence_distribution="CTC", **OP_POINT)
    return MultiSubjectTrainer(mp, list(subject_ids), VERBOSE=False, device="cpu",
                               SN_kwargs={"batch_size": 12, "max_dec_len": 10,
                                          "learning_rate": 3e-3})


def _val_wer(trainer, beam=1, temp=0.0):
    trainer.beam_width = beam
    trainer.SN_kwargs["temperature"] = temp
    out = trainer.assess(["validation"])["validation"]
    return out["word_error_rate"], out


@pytest.mark.slow
def test_decode_modes_at_operating_point(tmp_path):
    tr = _make_trainer(tmp_path / "op")
    tr.fit(num_epochs=160, assess=False)
    wer_greedy, out_g = _val_wer(tr)
    assert 0.0 < wer_greedy <= 0.3
    assert _val_wer(tr, beam=8)[0] <= wer_greedy

    manifests = tr.target_subject.data_manifests
    phoneme_list = manifests["encoder_1_targets"].feature_list
    id_map = {p: i for i, p in enumerate(phoneme_list)}
    lex = {w: [id_map[p] for p in word_to_phonemes(w.rstrip("_"))]
           for w in manifests["decoder_targets"].feature_list
           if not w.startswith("<") and all(p in id_map for p in word_to_phonemes(w.rstrip("_")))}
    trie, blank = LexiconTrie(lex), len(phoneme_list)
    ds = tr.packed_dataset("validation")
    with torch.inference_mode():
        enc_out, _, enc_lens = encode(tr.state.ema, tr.net_config,
                                      torch.from_numpy(ds.encoder_inputs[0]),
                                      torch.from_numpy(ds.encoder_lengths[0]), 0)
        enc_bm = enc_out.transpose(0, 1)
        hyps, n_phon = [], []
        for i in range(enc_bm.shape[0]):
            n = int(enc_lens[i])
            path, logp = _ctc_head_apply(tr.state.ema, tr.net_config, "encoder_1_targets",
                                         enc_bm[i:i + 1, :n], want_logp=True)
            n_phon.append(len([x for x in collapse_alignment(path[:, 0]) if int(x) != blank]))
            st = CTCWordBeamState(trie, beam_width=8)
            st.advance(logp[:, 0])
            hyps.append(" ".join(w.rstrip("_") for w in st.best()))
    wer_lex = float(np.mean(wer_vector(out_g["references"], hyps)))
    assert np.mean(n_phon) >= 3.0
    assert wer_lex < 0.5


@pytest.mark.slow
def test_transfer_beats_cold_at_operating_point(tmp_path):
    tr_tl = _make_trainer(tmp_path / "tl", subject_ids=(2, 1))
    tr_tl.sequential_transfer_learn(pretraining=40, training=80, posttraining=80)
    wer_tl, _ = _val_wer(tr_tl)
    tr_cold = _make_trainer(tmp_path / "cold")
    tr_cold.fit(num_epochs=160, assess=False)
    wer_cold, _ = _val_wer(tr_cold)
    assert wer_tl < wer_cold
    assert wer_cold > 0.0
