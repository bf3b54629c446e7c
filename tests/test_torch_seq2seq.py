"""The port's seq2seq (LSTM family, inference) held to the JAX package
at small shapes (the training half is held in ``test_torch_train.py``).

Parameters come from the JAX ``init_seq2seq`` and are carried across
with ``params_from_numpy``; inputs come from a numpy seed; the port runs
on the CPU (its plain versions).  f32: rtol 1e-4 / atol 1e-5 and
identical greedy tokens; bf16 encoder outputs: rtol 5e-2 / atol 2e-2.
With ``use_pallas_lstm=True`` the JAX side runs the Pallas kernel in
interpret mode (patched in for the test: ``encode`` does not pass the
interpret flag through).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ecog2txt_tpu.ops.pallas_lstm as jpallas
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch.convert import params_from_numpy
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
B, T, C = 3, 24, 5
LENGTHS = np.array([24, 17, 9], np.int32)

VARIANTS = {
    "plain": dict(),
    "bridge": dict(dec_rnn_sizes=(12,)),
    "attention": dict(use_attention=True),
    "no_conv": dict(conv_sizes=()),
}


def _kwargs(variant, **extra):
    kw = dict(
        vocab_size=20, in_channels=C, conv_sizes=(6,), decimation_factor=3,
        rnn_sizes=(8, 8), aux_heads=(), dec_embedding_size=6,
        dec_rnn_sizes=(16,), max_dec_len=6,
    )
    kw.update(VARIANTS[variant])
    kw.update(extra)
    return kw


def _configs(variant, dtype="float32", use_pallas=False):
    jcfg = js.Seq2SeqConfig(
        **_kwargs(variant, compute_dtype=getattr(jnp, dtype),
                  use_pallas_lstm=use_pallas)
    )
    tcfg = ts.Seq2SeqConfig(
        **_kwargs(variant, compute_dtype=getattr(torch, dtype),
                  use_pallas_lstm=use_pallas)
    )
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _params(variant):
    jcfg, _ = _configs(variant)
    jp = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, C)).astype(np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Route the JAX package's fused recurrence through interpret mode."""
    orig = jpallas.fused_lstm_recurrence

    def interpreted(xw, wh, lengths, h0, c0, mask, interpret=False,
                    reverse_time=False):
        return orig(xw, wh, lengths, h0, c0, mask, True, reverse_time)

    monkeypatch.setattr(jpallas, "fused_lstm_recurrence", interpreted)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32
    )


def _encode_both(variant, dtype="float32", use_pallas=False, jax_pallas=False):
    jp, tp = _params(variant)
    jcfg, tcfg = _configs(variant, dtype, use_pallas)
    if not jax_pallas:
        jcfg = dataclasses.replace(jcfg, use_pallas_lstm=False)
    x = _inputs()
    want = js.encode(
        jp, jcfg, jnp.asarray(x), jnp.asarray(LENGTHS), 0,
        jax.random.PRNGKey(0),
    )
    got = ts.encode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(LENGTHS), 0)
    return want, got


def test_convolve_sequences_parity():
    jp, tp = _params("plain")
    jcfg, tcfg = _configs("plain")
    xs = np.moveaxis(_inputs(), 0, 1).copy()  # (T, B, C)
    for rev in (None, LENGTHS):
        want = js.convolve_sequences(
            jp, jcfg, jnp.asarray(xs), 0, jax.random.PRNGKey(0), False,
            reverse_lengths=None if rev is None else jnp.asarray(rev),
        )
        got = ts.convolve_sequences(
            tp, tcfg, torch.from_numpy(xs), 0,
            reverse_lengths=None if rev is None else torch.from_numpy(rev),
        )
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("variant", ["plain", "no_conv"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_parity_f32(variant, use_pallas):
    # at f32 the JAX scan and the JAX kernel agree, so the JAX side runs
    # the scan; the port runs its kernel path's plain version or its scan
    (oj, (hj, cj), lj), (ot, (ht, ct), lt) = _encode_both(
        variant, use_pallas=use_pallas
    )
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for g, w in ((ot, oj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_encode_parity_bf16_kernel_path(interpret_pallas):
    (oj, (hj, cj), _), (ot, (ht, ct), _) = _encode_both(
        "plain", "bfloat16", use_pallas=True, jax_pallas=True
    )
    assert ot.dtype == torch.bfloat16
    for g, w in ((ot, oj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


@pytest.mark.parametrize("variant", ["plain", "bridge", "attention"])
def test_teacher_forcing_logits_parity(variant):
    jp, tp = _params(variant)
    jcfg, tcfg = _configs(variant)
    (oj, fj, lj), (ot, ft, lt) = _encode_both(variant)
    targets = np.random.default_rng(3).integers(3, 20, size=(B, 5)).astype(
        np.int32
    )
    want = js.decoder_teacher_forcing(
        jp, jcfg, fj, jnp.asarray(targets), jax.random.PRNGKey(0),
        enc_out=oj, enc_lengths=lj,
    )
    got = ts.decoder_teacher_forcing(
        tp, tcfg, ft, torch.from_numpy(targets), enc_out=ot, enc_lengths=lt
    )
    assert got.shape == (5, B, 20)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("variant", ["plain", "bridge", "attention", "no_conv"])
def test_greedy_decode_tokens_identical(variant):
    jp, tp = _params(variant)
    jcfg, tcfg = _configs(variant, use_pallas=True)
    jcfg = dataclasses.replace(jcfg, use_pallas_lstm=False)
    x = _inputs(5)
    want = js.greedy_decode(
        jp, jcfg, jnp.asarray(x), jnp.asarray(LENGTHS), 0, temperature=0.0
    )
    got = ts.greedy_decode(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(LENGTHS), 0,
        temperature=0.0,
    )
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling():
    _, tp = _params("plain")
    _, tcfg = _configs("plain")
    x = torch.from_numpy(_inputs(6))
    lens = torch.from_numpy(LENGTHS)

    def sample(seed, temperature):
        g = torch.Generator().manual_seed(seed)
        return ts.greedy_decode(
            tp, tcfg, x, lens, 0, generator=g, temperature=temperature
        )

    a, b = sample(1, 1.0), sample(1, 1.0)
    np.testing.assert_array_equal(a.numpy(), b.numpy())  # seeded: repeatable
    assert ((a >= 0) & (a < 20)).all()
    # a vanishing temperature is the argmax
    greedy = ts.greedy_decode(tp, tcfg, x, lens, 0, temperature=0.0)
    np.testing.assert_array_equal(sample(2, 1e-6).numpy(), greedy.numpy())
    draws = torch.stack([sample(s, 5.0) for s in range(4)])
    assert len(torch.unique(draws)) > 1


def test_init_seq2seq_matches_the_jax_tree():
    for variant in ("bridge", "attention"):
        jcfg, tcfg = _configs(variant)
        jtree = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
        ttree = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")
        jleaves, jdef = jax.tree.flatten(jtree)
        tleaves, tdef = jax.tree.flatten(ttree)
        assert str(jdef) == str(tdef)
        assert [a.shape for a in jleaves] == [tuple(t.shape) for t in tleaves]
        assert all(t.dtype == torch.float32 for t in tleaves)


def test_unported_paths_name_the_roadmap():
    # the conformer's mixture-of-experts FFN (models/moe.py) is ported: the
    # config builds (tests/test_torch_moe.py holds it to JAX)
    moe = ts.Seq2SeqConfig(vocab_size=20, encoder_type="conformer",
                           conformer=ts.ConformerConfig(moe_experts=4))
    assert moe.conformer.moe_experts == 4 and moe.enc_out_dim == moe.conformer.model_dim
    # the CTC aux head (models/ctc.py) is ported: the loss runs
    _, tcfg = _configs("plain")
    tcfg = dataclasses.replace(tcfg, aux_heads=(ts.AuxHead("ph", "CTC", 4),))
    tp = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {
        "encoder_inputs": torch.from_numpy(_inputs()),
        "encoder_lengths": torch.from_numpy(LENGTHS),
        "decoder_targets": torch.ones((B, 2), dtype=torch.int32),
        "decoder_lengths": torch.full((B,), 2, dtype=torch.int32),
        "subject_idx": 0, "ph": torch.zeros((B, 3), dtype=torch.int32),
        "ph_lengths": torch.full((B,), 2, dtype=torch.int32),
    }
    loss, metrics = ts.seq2seq_loss(tp, tcfg, batch, train=False)
    assert torch.isfinite(loss) and torch.isfinite(metrics["loss_ph"])
    with pytest.raises(TypeError):
        ts.Seq2SeqConfig(vocab_size=20, compute_dtype=jnp.float32)
