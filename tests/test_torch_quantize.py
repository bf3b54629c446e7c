"""The port's int8 serving quantization held to the JAX package.

``quantize.py`` against ``ecog2txt_tpu/quantize.py`` on the same weights
and seeded inputs: ``quantize_weight`` bit for bit; the int8 x int8 →
int32 sums of ``int8_mm`` (the CPU product, in float64) bit-equal to
JAX's ``dot_general(preferred_element_type=int32)``, at K = 100 (the
conformer's ``in_proj``) and at 16 rows or fewer; ``int8_dot`` within
JAX's own quantization bound of the float product and equal to JAX's
``int8_dot`` at f32 tolerance; ``quantize_conformer_params`` (expert-stacked
MoE weights stay float), the quantized encode against JAX's quantized
encode and within JAX's bounds of the float encode; the JAX package's
quantized tree carried across by ``params_from_numpy``; and
``quantize='int8'`` sessions and pools equal to the offline decode with
the same quantized weights (``tests/test_quantize.py``'s contract) and
to JAX's session.  Tolerances: f32 rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import quantize as jq
from ecog2txt_tpu import serve as jserve
from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import quantize as tq
from ecog2txt_tpu_torch import serve as tserve
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_leaves, tree_map
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
CONFORMER = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
                 chunk_size=4, left_context=1)
KW = dict(vocab_size=12, num_subjects=1, in_channels=8, conv_sizes=(16,),
          decimation_factor=4, rnn_sizes=(24,), aux_proj_sizes=(), aux_heads=(),
          dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6,
          encoder_type="conformer")
TARGETS = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(9)]


def test_quantize_weight_matches_jax_bit_for_bit():
    w = np.random.default_rng(0).normal(size=(96, 80)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    assert tw.q.dtype == torch.int8 and tuple(tw.scale.shape) == (80,)
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    werr = np.abs(tq.dequantize_weight(tw).numpy() - w)
    assert (werr <= np.abs(w).max(axis=0, keepdims=True) / 254 + 1e-7).all()


@pytest.mark.parametrize("M,K,N", [(64, 100, 384), (16, 100, 384), (5, 96, 80), (1, 384, 1152)])
def test_int8_sums_are_bit_equal_to_jax(M, K, N):
    """Extreme operands (|sum| up to 127^2 K) included: the float64 product
    is exact, so the int32 sums equal JAX's bit for bit."""
    rng = np.random.default_rng(M + K)
    a = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    b = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    a[0], b[:, 0] = 127, -127
    want = np.asarray(jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = tq.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[0, 0]) == -127 * 127 * K
    with pytest.raises(TypeError):
        tq.int8_mm(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_int8_dot_matches_jax_and_the_quantization_bound():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16, 96)).astype(np.float32)
    w = rng.normal(size=(96, 80)).astype(np.float32)
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.from_numpy(w))
    want = np.asarray(jq.int8_dot(jnp.asarray(x), jw, jnp.float32))
    got = tq.int8_dot(torch.from_numpy(x), tw, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    ref = x @ w
    assert np.abs(got.numpy() - ref).max() <= 0.02 * np.abs(ref).max()
    assert tq.int8_dot(torch.from_numpy(x), tw, torch.bfloat16).dtype == torch.bfloat16


def _assert_trees_equal(got, want, path="params"):
    """Leaf by leaf, by key (dicts), index (lists) and field (the int8
    weights' ``q`` and ``scale``)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want) and type(got).__name__ == type(want).__name__, path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


def _conformer_tree(moe: int = 0):
    cfg = tc.ConformerConfig(**CONFORMER, moe_experts=moe)
    return tree_map(lambda t: t.numpy(), tc.init_conformer(
        torch.Generator().manual_seed(0), cfg, 20, device="cpu"))


@pytest.mark.parametrize("impl", ["dense", "fused"])
def test_quantized_encode_matches_jax_and_stays_close_to_float(impl):
    """The quantized tree's int8 leaves equal JAX's; the quantized encode
    equals JAX's quantized encode (f32) and is within JAX's bounds of the
    float encode (cosine > 0.999, max abs err < 5% of the max); under
    'fused' it runs 'flash', the same function."""
    tree = _conformer_tree()
    jqp = jq.quantize_conformer_params(jax.tree.map(jnp.asarray, tree))
    tqp = tq.quantize_conformer_params(params_from_numpy(tree, "cpu"))
    assert tq.is_quantized(tqp) and not tq.is_quantized(params_from_numpy(tree, "cpu"))
    _assert_trees_equal(tqp, jqp)
    x = np.random.default_rng(2).normal(size=(3, 40, 20)).astype(np.float32)
    lens = np.array([40, 25, 40], np.int32)
    valid = (np.arange(40)[None] < lens[:, None])[..., None]
    jcfg = jc.ConformerConfig(**CONFORMER, attention_impl="dense")
    want, _ = jax.jit(lambda p: jc.conformer_encode(p, jcfg, jnp.asarray(x), jnp.asarray(lens)))(jqp)
    cfg = tc.ConformerConfig(**CONFORMER, attention_impl=impl)
    got, _ = tc.conformer_encode(tqp, cfg, torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0), np.where(valid, want, 0), **F32)
    ref, _ = tc.conformer_encode(params_from_numpy(tree, "cpu"), cfg, torch.from_numpy(x),
                                 torch.from_numpy(lens))
    ref, out = ref.numpy(), got.numpy()
    assert (ref * out).sum() / (np.linalg.norm(ref) * np.linalg.norm(out)) > 0.999
    assert np.abs(out - ref).max() < 0.05 * np.abs(ref).max()


def test_moe_expert_weights_stay_float_and_jax_trees_carry_across():
    """A MoE ffn2 keeps its expert-stacked (E, ., .) weights float, as in
    JAX; the JAX package's quantized tree (numpy leaves) comes across as
    the port's ``QuantizedWeight`` s, and ``tree_map`` keeps them whole."""
    tree = _conformer_tree(moe=4)
    tqp = tq.quantize_conformer_params(params_from_numpy(tree, "cpu"))
    ffn2 = tqp["blocks"][0]["ffn2"]
    assert ffn2["w1"].dtype == torch.float32 and ffn2["w1"].dim() == 3
    assert isinstance(tqp["blocks"][0]["ffn1"]["w1"], tq.QuantizedWeight)
    jqp = jax.tree.map(np.asarray, jq.quantize_conformer_params(jax.tree.map(jnp.asarray, tree)))
    carried = params_from_numpy(jqp, "cpu")
    assert isinstance(carried["in_proj"]["w"], tq.QuantizedWeight)
    moved = tree_map(lambda t: t.clone(), carried)
    assert isinstance(moved["blocks"][1]["attn"]["wqkv"], tq.QuantizedWeight)
    _assert_trees_equal(moved, tqp)
    assert len(tree_leaves(moved)) == len(jax.tree.leaves(jqp))


def test_quantized_sessions_match_the_quantized_offline_decode():
    """``quantize='int8'`` session and pool: endpoint tokens equal the
    offline ``greedy_decode`` with the same quantized parameters and the
    JAX package's quantized session; an unknown mode raises."""
    jcfg = js.Seq2SeqConfig(**KW, conformer=jc.ConformerConfig(**CONFORMER))
    tcfg = ts.Seq2SeqConfig(**KW, conformer=tc.ConformerConfig(**CONFORMER))
    tree = tree_map(lambda t: t.numpy(), ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0),
                                                         device="cpu"))
    raw = np.random.default_rng(5).normal(size=(131, 8)).astype(np.float32)
    L = len(raw)
    inputs = np.zeros((1, -(-L // 4) * 4, 8), np.float32)
    inputs[0, :L] = raw
    qparams = tq.quantize_conformer_params(params_from_numpy(tree, "cpu"))
    with torch.inference_mode():
        offline = ts.greedy_decode(qparams, tcfg, torch.from_numpy(inputs), torch.tensor([L]), 0,
                                   temperature=0.0).numpy()
    params = params_from_numpy(tree, "cpu")
    sess = tserve.StreamingConformerSession(params, tcfg, TARGETS, quantize="int8", device="cpu")
    pool = tserve.StreamingSessionPool(params, tcfg, TARGETS, capacity=2, quantize="int8",
                                       device="cpu")
    jsess = jserve.StreamingConformerSession(jax.tree.map(jnp.asarray, tree), jcfg, TARGETS,
                                             quantize="int8")
    slot = pool.add()
    for lo in range(0, L, 29):
        sess.push(raw[lo: lo + 29])
        pool.push(slot, raw[lo: lo + 29])
        jsess.push(raw[lo: lo + 29])
    got = sess.endpoint()["tokens"]
    np.testing.assert_array_equal(got, offline)
    np.testing.assert_array_equal(pool.endpoint(slot)["tokens"], offline)
    np.testing.assert_array_equal(got, np.asarray(jsess.endpoint()["tokens"]))
    # a tree quantized already is not quantized twice
    assert tserve._maybe_quantize(qparams, "int8") is qparams
    with pytest.raises(ValueError, match="quantize"):
        tserve.StreamingConformerSession(params, tcfg, TARGETS, quantize="int4", device="cpu")
