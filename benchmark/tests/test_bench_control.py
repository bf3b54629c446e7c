"""``correct`` comes out false where it must.

On the CPU, at small sizes, a whole run of each cell (the look for a card
skipped) with the timed path broken underneath: a step that returns its
state unchanged and a step that leaves out half of its batch, taking the
mean over the rest (training); a token altered where the decoder
produces it (assessment).  A sound run of the same size is correct.  On
the card (``-m gpu``), at the cell's own size on three seeds, sound runs
pass and the control, the reference in float8 in the program's place,
fails the comparison."""

from __future__ import annotations

import pytest
import torch

import ecog2txt_tpu_torch.models.seq2seq as program_seq2seq
import ecog2txt_tpu_torch.train as program_train
from benchmark.harness import registry
from benchmark.harness.judge import grad1_vs_bf16, verdict
from benchmark.run import run_cell

SMALL = {"in_channels": 8, "conv_sizes": [6], "decimation_factor": 4, "rnn_sizes": [5, 5],
         "aux_proj_sizes": [7],
         "aux_heads": [{"name": "encoder_1_targets", "distribution": "categorical", "out_dim": 5}],
         "dec_embedding_size": 6, "dec_rnn_sizes": [10], "vocab_size": 13, "max_dec_len": 5,
         "compute_dtype": "float32"}
CONFORMER = {"num_blocks": 2, "model_dim": 8, "num_heads": 2, "ffn_dim": 16, "conv_kernel": 3,
             "chunk_size": 4, "left_context": 1, "attention_impl": "flash"}
TRAFFIC = {"trials": 10, "samples": 32, "decoder_tokens": 4, "batch": 4, "epochs_per_segment": 2}
TRAIN = ("bilstm-makin2020.train-b256",)
ASSESS = ("bilstm-makin2020.assess-b450", "conformer-m.assess-b450")


def _run(workload: str) -> dict:
    model = dict(SMALL)
    if workload.startswith("conformer"):
        model["conformer"] = CONFORMER
    torch.set_num_threads(2)
    result, _ = run_cell(workload, 2**31 + 99, 0.3, trace=False, device="cpu",
                         overrides={"model": model, "traffic": TRAFFIC})
    return result


@pytest.mark.parametrize("workload", TRAIN + ASSESS)
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "compared"
    ends = registry.metrics_for(registry.benchmark(), workload, per_layer=False)
    assert set(result["metrics"]) == {m["name"] for m in ends} > {"setup_s"}


def _unchanged_state(monkeypatch):
    def make_step(loss_fn, ema_decay, mesh=None, clip_norm=None, split=None):
        def step(params, ema, optimizer, batch, generator=None):
            with torch.no_grad():
                return loss_fn(params, batch, generator)
        return step

    monkeypatch.setattr(program_train, "make_dp_train_step", make_step)


def _half_batch(monkeypatch):
    make = program_train.make_dp_train_step

    def make_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(params, ema, optimizer, batch, generator=None):
            rows = {k: (v if k == "subject_idx" else v[: len(v) // 2]) for k, v in batch.items()}
            return step(params, ema, optimizer, rows, generator)
        return half

    monkeypatch.setattr(program_train, "make_dp_train_step", make_step)


def _token_altered(monkeypatch):
    decode = program_seq2seq.decode_from_encoder

    def altered(params, config, *args, **kwargs):
        tokens = decode(params, config, *args, **kwargs).clone()
        tokens[:, 0] = (tokens[:, 0] + config.vocab_size // 2) % config.vocab_size
        return tokens

    monkeypatch.setattr(program_seq2seq, "decode_from_encoder", altered)


@pytest.mark.parametrize("workload, fault", [(w, f) for w in TRAIN
                                              for f in (_unchanged_state, _half_batch)]
                         + [(w, _token_altered) for w in ASSESS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(workload)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["compared"].values())


def test_grad1_vs_bf16_holds_the_program_to_the_bfloat16_reference():
    """About 1 where the program errs as bfloat16 does, the worst kept
    leaf's ratio where it errs more, and a leaf that bfloat16 itself does
    not keep within a tenth left out."""
    g = torch.Generator().manual_seed(5)
    want = {"grads1": [torch.randn(64, generator=g) for _ in range(4)]}
    noise = [torch.randn(64, generator=g) for _ in range(4)]
    off = lambda share: {"grads1": [w + s * n * w.norm() / n.norm()  # noqa: E731
                                    for w, n, s in zip(want["grads1"], noise, share)]}
    witness = off([0.01, 0.02, 0.04, 0.5])
    assert grad1_vs_bf16(witness, want, witness) == pytest.approx(1.0)
    assert grad1_vs_bf16(off([0.01, 0.06, 0.04, 0.5]), want, witness) == pytest.approx(3.0)
    assert grad1_vs_bf16(off([0.01, 0.02, 0.04, 5.0]), want, witness) == pytest.approx(1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", TRAIN + ASSESS)
def test_the_control_at_the_cells_size(workload, card):
    from benchmark.calibrate import readings

    limits = registry.limits(workload)
    for seed in (2**31 + 1, 2**32 + 7, 3 * 10**9 + 11):
        got = readings(workload, seed, card)
        assert verdict(got["program"], limits)[0], got["program"]
        assert not verdict(got["control"], limits)[0], got["control"]
