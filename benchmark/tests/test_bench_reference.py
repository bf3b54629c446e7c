"""The plain reference (``benchmark/reference/``) against the program at
small sizes on the CPU: the same weights, rows and dropout generators give
the same losses, gradients, Adam steps, EMA and greedy tokens.  Also the
benchmark's weights against the program's ``init_seq2seq`` layout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import port
from benchmark.harness.traffic import derive, gather_batch, make_corpus, segment_schedule
from benchmark.harness.weights import layout, make_weights
from benchmark.reference import seq2seq as ref
from benchmark.harness import registry

from ecog2txt_tpu_torch.convert import tree_leaves
from ecog2txt_tpu_torch.models.seq2seq import init_seq2seq

SMALL = {"in_channels": 8, "conv_sizes": [6], "decimation_factor": 4, "rnn_sizes": [5, 7],
         "aux_proj_sizes": [7],
         "aux_heads": [{"name": "encoder_1_targets", "distribution": "categorical", "out_dim": 5}],
         "dec_embedding_size": 6, "dec_rnn_sizes": [14], "vocab_size": 13, "max_dec_len": 5,
         "compute_dtype": "float32"}
CONFORMER = {"num_blocks": 2, "model_dim": 8, "num_heads": 2, "ffn_dim": 16, "conv_kernel": 3,
             "chunk_size": 4, "left_context": 1}
TRAFFIC = {"trials": 10, "samples": 32, "decoder_tokens": 4, "batch": 4, "epochs_per_segment": 1}
CONFIGS = ("bilstm-makin2020", "conformer-m")


def _model(name: str, attention: str = "flash") -> dict:
    model = {**registry.config(registry.benchmark(), name)["model"], **SMALL}
    if model["encoder_type"] == "conformer":
        model["conformer"] = {**CONFORMER, "attention_impl": attention}
    return model


def _program_steps(model, training, corpus, weights, seed):
    """The benchmark's checked calls of the segment runner: the first step
    alone, then steps 2 and 3 as one call, a dropout generator a call."""
    state = port.train_state(weights, float(training["learning_rate"]))
    runner = port.segment_runner(port.seq2seq_config(model), training)
    subjects, idx = segment_schedule({**TRAFFIC, "epochs_per_segment": 2}, seed, 0)
    calls = []
    for part, (a, b) in enumerate(((0, 1), (1, 3))):
        gen = torch.Generator().manual_seed(derive(seed, "dropout", 0, part))
        state, metrics = runner(state, corpus, subjects[a:b], idx[a:b], gen, 0)
        calls.append(float(metrics["loss_total"]))
        if part == 0:
            grads1 = [g.clone() for g in port.first_gradient(state)]
    return calls, grads1, state, (subjects, idx)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("rows", [None, 3])
def test_training_steps_match_the_program(name, rows):
    """Three steps with dropout on, the first alone and two in one call:
    the calls' losses, the first clipped gradient, the parameters and the
    EMA after them, leaf by leaf."""
    torch.manual_seed(0)
    model = _model(name)
    training = registry.config(registry.benchmark(), name)["training"]
    seed = 2**31 + 17
    corpus = make_corpus(model, TRAFFIC, seed, "cpu")
    weights = make_weights(model, derive(seed, "weights"), "cpu")
    first = ref.tree_map(lambda t: t.clone(), weights)
    calls, grads1, state, (subjects, idx) = _program_steps(model, training, corpus, weights, seed)
    gens = [torch.Generator().manual_seed(derive(seed, "dropout", 0, part)) for part in (0, 1)]
    steps = [(gather_batch(corpus, int(subjects[k]), idx[k]),
              ref.draw_masks(model, gens[min(k, 1)], len(idx[k]), TRAFFIC["samples"],
                             TRAFFIC["decoder_tokens"], "cpu"))
             for k in range(3)]
    want = ref.train_steps(first, model, training, steps, "float32", rows)
    np.testing.assert_allclose(calls, [want["losses"][0], np.mean(want["losses"][1:])], rtol=1e-5)
    for got, exp in ((grads1, want["grads1"]), (tree_leaves(state.params), want["params"]),
                     (tree_leaves(state.ema), want["ema"])):
        assert len(got) == len(exp)
        for a, b in zip(got, exp):
            torch.testing.assert_close(a.detach(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_logits_rank_the_greedy_tokens_first(name):
    """Fed the program's greedy tokens, the reference's best logit is the
    served token's at every position up to EOS (float32)."""
    model = _model(name)
    seed = 5
    corpus = make_corpus(model, TRAFFIC, seed, "cpu")
    weights = make_weights(model, derive(seed, "weights"), "cpu")
    inputs, lengths = corpus["encoder_inputs"][0], corpus["encoder_lengths"][0]
    tokens = port.decode(weights, port.seq2seq_config(model), inputs, lengths, None)
    logits = ref.decode_logits(weights, model, inputs, lengths, 0, tokens, "float32", 4)
    gap = logits.max(-1).values - torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
    assert float(gap.max()) < 1e-5


def test_conformer_attention_matches_the_dense_oracle():
    """The reference's chunk-causal attention against the program's
    'dense' implementation on ragged lengths."""
    from ecog2txt_tpu_torch.models.conformer import ConformerConfig, conformer_encode

    model = _model("conformer-m", "dense")
    weights = make_weights(model, 3, "cpu")
    conf = weights["encoder"]["conformer"]
    x = torch.randn(3, 11, model["conv_sizes"][0], generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([11, 7, 4])
    got, _ = conformer_encode(conf, ConformerConfig(**model["conformer"]), x, lengths)
    want = ref.conformer(ref.exact, conf, model["conformer"], x, lengths)
    valid = torch.arange(11)[None, :] < lengths[:, None]
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_have_the_program_layout_at_full_width(name):
    """The benchmark's layout has ``init_seq2seq``'s keys and shapes at the
    configuration's own widths."""
    model = registry.config(registry.benchmark(), name)["model"]
    program = init_seq2seq(port.seq2seq_config(model), torch.Generator().manual_seed(0), "cpu")
    mine = layout(model)

    def shapes(tree, spec):
        if isinstance(tree, dict):
            assert list(tree) == list(spec)
            return [s for k in tree for s in shapes(tree[k], spec[k])]
        if isinstance(tree, list):
            assert len(tree) == len(spec)
            return [s for a, b in zip(tree, spec) for s in shapes(a, b)]
        return [(tuple(tree.shape), tuple(spec.shape))]

    for got, want in shapes(program, mine):
        assert got == want


def test_fp8_rounds_and_passes_the_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.fp8(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.ones_like(x))
