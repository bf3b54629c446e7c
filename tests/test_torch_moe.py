"""The port's routed mixture-of-experts FFN held to the JAX package.

``models.moe`` against ``ecog2txt_tpu/models/moe.py`` on the same
parameters (``params_from_numpy``) and seeded numpy inputs: the router
(logits, probabilities, gates, expert choices), its statistics and the
weighted aux loss; the no-drop and capacity outputs, grouped capacity with
T padded up to whole segments and ragged lengths; the kept (token,
choice) pairs and their combine weights, read out through a probe
(first layer 0, second-layer biases one-hot a expert, so each token's
output is its kept gates by expert); ties under a zero router; the MoE
conformer's encode and ``seq2seq_loss`` with every gradient leaf against
``jax.grad``; a step of the segment runner reporting ``moe_aux``;
per-row offsets; the no-drop stream against the offline encode, and the
capacity stream refused.  Tolerances: f32 rtol 1e-4 / atol 1e-5, bf16
rtol 5e-2 / atol 2e-2; the kept pairs exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import moe as jm
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_map
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models import moe as tm
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
D, FF, E = 16, 24, 4
CFG = dict(num_blocks=2, model_dim=D, num_heads=2, ffn_dim=FF, conv_kernel=4,
           chunk_size=4, left_context=1, moe_experts=E, moe_topk=2)
B, T = 3, 21
LENGTHS = np.array([21, 13, 17], np.int32)
VALID = np.arange(T)[None] < LENGTHS[:, None]

# (capacity factor, group size): no-drop, one group a row with drops,
# groups of 8 steps (T=21 padded to 24) with drops, ample capacity
CASES = [(0.0, 0), (0.75, 0), (0.5, 8), (8.0, 8)]


def _ffn_tree(seed=0):
    p = tm.init_moe_ffn(torch.Generator().manual_seed(seed), D, FF, E)
    tree = tree_map(lambda t: t.numpy(), p)
    rng = np.random.default_rng(seed)
    tree["b1"] = rng.normal(size=(E, FF)).astype(np.float32) * 0.1
    tree["b2"] = rng.normal(size=(E, D)).astype(np.float32) * 0.1
    return tree


def _xn(seed=1):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)


def _configs(cf=0.0, seg=0, **kw):
    return (jc.ConformerConfig(**{**CFG, **kw}, moe_capacity_factor=cf, moe_group_size=seg),
            tc.ConformerConfig(**{**CFG, **kw}, moe_capacity_factor=cf, moe_group_size=seg))


def _jax_moe(tree, xn, cfg, valid, cd=jnp.float32):
    fn = jax.jit(lambda p, x, v: jm.moe_ffn(p, x, cfg, cd, v))
    return jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(xn).astype(cd),
                                       jnp.asarray(valid)))


def test_router_statistics_and_aux_match_jax():
    """Logits, probabilities and gates (f32) and the chosen experts
    (exactly); the statistics and the weighted aux loss."""
    tree, xn = _ffn_tree(), _xn()
    jcfg, tcfg = _configs()
    jl, jp, jg, ji = jax.tree.map(np.asarray, jm._route(jax.tree.map(jnp.asarray, tree),
                                                        jnp.asarray(xn), 2))
    p = params_from_numpy(tree, "cpu")
    tl, tp, tg, ti = tm._route(p, torch.from_numpy(xn), 2)
    np.testing.assert_array_equal(ti.numpy(), ji)
    for got, want in ((tl, jl), (tp, jp), (tg, jg)):
        np.testing.assert_allclose(got.numpy(), want, **F32)
    jstats = jm.router_stats(jl, jp, ji, jnp.asarray(VALID))
    tstats = tm.router_stats(tl, tp, ti, torch.from_numpy(VALID))
    for k in jstats:
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), err_msg=k, **F32)
    np.testing.assert_allclose(float(tm.aux_from_stats(tcfg, tstats)),
                               float(jm.aux_from_stats(jcfg, jstats)), **F32)
    zero = tm.zero_stats(E)
    assert all(float(v.sum()) == 0 for v in zero.values()) and zero["fsum"].shape == (E,)


def test_zero_router_ties_pick_the_lowest_experts():
    """Every probability equal (wg = 0): each token picks experts 0..k-1,
    as ``jax.lax.top_k`` orders ties; so do partial ties (two equal
    columns of wg)."""
    tree, xn = _ffn_tree(), _xn()
    tree["wg"] = np.zeros_like(tree["wg"])
    for k in (1, 2, 3):
        _, _, gates, idx = tm._route(params_from_numpy(tree, "cpu"), torch.from_numpy(xn), k)
        assert (idx.numpy() == np.arange(k)).all()
        np.testing.assert_allclose(gates.numpy(), 1.0 / k, **F32)
    tied = _ffn_tree(3)
    tied["wg"][:, 2] = tied["wg"][:, 0]
    tied["wg"][:, 3] = tied["wg"][:, 1]
    _, _, _, ji = jm._route(jax.tree.map(jnp.asarray, tied), jnp.asarray(xn), 3)
    _, _, _, ti = tm._route(params_from_numpy(tied, "cpu"), torch.from_numpy(xn), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("cf,seg", CASES)
def test_moe_ffn_matches_jax(cf, seg):
    """No-drop, capacity and grouped capacity (ragged lengths; T padded up
    to whole groups): output on valid tokens (invalid tokens weigh 0 in
    both) and the statistics, f32; the output in bf16."""
    tree, xn = _ffn_tree(), _xn()
    jcfg, tcfg = _configs(cf, seg)
    jout, jstats = _jax_moe(tree, xn, jcfg, VALID)
    out, stats = tm.moe_ffn(params_from_numpy(tree, "cpu"), torch.from_numpy(xn), tcfg,
                            torch.float32, torch.from_numpy(VALID))
    np.testing.assert_allclose(out.numpy(), jout, **F32)
    for k in jstats:
        np.testing.assert_allclose(stats[k].numpy(), jstats[k], err_msg=k, **F32)
    jbf, _ = _jax_moe(tree, xn, jcfg, VALID, jnp.bfloat16)
    bf, _ = tm.moe_ffn(params_from_numpy(tree, "cpu"), torch.from_numpy(xn).bfloat16(), tcfg,
                       torch.bfloat16, torch.from_numpy(VALID))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), np.asarray(jbf, np.float32), **BF16)


@pytest.mark.parametrize("cf,seg", CASES[1:])
def test_capacity_keeps_the_jax_pairs_exactly(cf, seg):
    """The probe (w1 = 0, b1 = 0, w2 = 0, b2[e] = one-hot e) turns each
    token's output into its kept gates by expert: the kept (token, expert)
    pairs are the JAX package's exactly and their combine weights equal
    within f32; ``capacity_slots`` keeps the same pairs, and every kept
    choice has its own slot."""
    tree, xn = _ffn_tree(), _xn()
    for key in ("w1", "b1", "w2"):
        tree[key] = np.zeros_like(tree[key])
    tree["b2"] = np.eye(E, D, dtype=np.float32)
    jcfg, tcfg = _configs(cf, seg)
    jout, _ = _jax_moe(tree, xn, jcfg, VALID)
    p = params_from_numpy(tree, "cpu")
    out, _ = tm.moe_ffn(p, torch.from_numpy(xn), tcfg, torch.float32, torch.from_numpy(VALID))
    jw, tw = jout[..., :E], out.numpy()[..., :E]
    np.testing.assert_array_equal(tw != 0, jw != 0)
    np.testing.assert_allclose(tw, jw, **F32)
    assert (jw != 0).sum() < 2 * VALID.sum() or cf == 8.0  # some choices dropped
    # the slot assignment itself, on the groups moe_ffn builds
    S = seg or T
    pad = (-T) % S
    xg = torch.from_numpy(np.pad(xn, ((0, 0), (0, pad), (0, 0)))).reshape(-1, S, D)
    vg = torch.from_numpy(np.pad(VALID, ((0, 0), (0, pad)))).reshape(-1, S)
    C = max(int(np.ceil(2 * S / E * cf)), 1)
    _, _, _, idx = tm._route(p, xg, 2)
    slot, keep = tm.capacity_slots(idx, vg, E, C)
    kept = np.zeros(vg.shape + (E,), bool)
    g, s, j = np.nonzero(keep.numpy())
    kept[g, s, idx.numpy()[g, s, j]] = True
    np.testing.assert_array_equal(kept.reshape(B, -1, E)[:, :T], jw != 0)
    cells = set(zip(g, idx.numpy()[g, s, j], slot.numpy()[g, s, j]))
    assert len(cells) == len(g) and (slot.numpy()[g, s, j] < C).all()


@functools.lru_cache(maxsize=None)
def _jax_encode(cf, seg):
    tree = tree_map(lambda t: t.numpy(), tc.init_conformer(
        torch.Generator().manual_seed(0), _configs(cf, seg)[1], 6, device="cpu"))
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(B, T, 6)).astype(np.float32)
    cot = np.where(VALID[..., None], rng.normal(size=(B, T, D)), 0).astype(np.float32)
    jcfg = _configs(cf, seg, attention_impl="dense")[0]

    def loss(p):
        out, _, aux = jc.conformer_encode(p, jcfg, jnp.asarray(xs), jnp.asarray(LENGTHS),
                                          return_aux=True)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    return jax.tree.map(np.asarray, (tree, out, aux, grads)) + (xs, cot)


@pytest.mark.parametrize("cf,seg,impl", [(0.0, 0, "flash"), (0.5, 8, "banded"),
                                         (0.75, 0, "fused")])
def test_moe_conformer_encode_and_grads_match_jax(cf, seg, impl):
    """``conformer_encode(return_aux=True)``: outputs on valid rows, the aux
    loss and every parameter gradient (router and experts included) of
    ``sum(out * cot) + aux`` against ``jax.grad``, f32."""
    tree, out_j, aux_j, grads_j, xs, cot = _jax_encode(cf, seg)
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    cfg = _configs(cf, seg, attention_impl=impl)[1]
    out, _, aux = tc.conformer_encode(params, cfg, torch.from_numpy(xs),
                                      torch.from_numpy(LENGTHS), return_aux=True)
    np.testing.assert_allclose(np.where(VALID[..., None], out.detach().numpy(), 0),
                               np.where(VALID[..., None], out_j, 0), **F32)
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), **F32)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    got = tree_map(lambda t: t.grad.numpy(), params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(a, b, **F32)
    _, _, stats = tc.conformer_encode(params, cfg, torch.from_numpy(xs),
                                      torch.from_numpy(LENGTHS), return_moe_stats=True)
    assert len(stats) == CFG["num_blocks"] and float(stats[0]["n"]) == VALID.sum()


SEQ = dict(vocab_size=20, num_subjects=1, in_channels=5, conv_sizes=(7,),
           decimation_factor=3, rnn_sizes=(8,), aux_proj_sizes=(), dec_embedding_size=6,
           dec_rnn_sizes=(10,), max_dec_len=5, encoder_type="conformer")


def _seq_batch(seed=0, n=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 6, size=n).astype(np.int32)
    dec = rng.integers(3, 20, size=(n, 5)).astype(np.int32)
    pos = np.arange(5)
    dec = np.where(pos == lens[:, None] - 1, 1, dec)
    dec = np.where(pos >= lens[:, None], 0, dec).astype(np.int32)
    return {"encoder_inputs": rng.normal(size=(n, 36, 5)).astype(np.float32),
            "encoder_lengths": rng.integers(20, 37, size=n).astype(np.int32),
            "decoder_targets": dec, "decoder_lengths": lens}


@pytest.mark.parametrize("cf,seg", [(0.0, 0), (0.5, 4)])
def test_moe_seq2seq_loss_and_runner(cf, seg):
    """``seq2seq_loss`` of the MoE conformer: total, ``moe_aux`` and every
    gradient leaf against ``jax.grad`` at train=False; one segment-runner
    step reports ``moe_aux``."""
    jcfg = js.Seq2SeqConfig(**SEQ, conformer=_configs(cf, seg, num_blocks=1,
                                                      attention_impl="dense")[0])
    tcfg = ts.Seq2SeqConfig(**SEQ, conformer=_configs(cf, seg, num_blocks=1,
                                                      attention_impl="flash")[1])
    tree = tree_map(lambda t: t.numpy(), ts.init_seq2seq(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    jb = {k: jnp.asarray(v) for k, v in _seq_batch().items()}
    jb["subject_idx"] = jnp.asarray(0)
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: js.seq2seq_loss(p, jcfg, jb, jax.random.PRNGKey(0), train=False),
        has_aux=True))(tree)
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _seq_batch().items()}
    batch["subject_idx"] = 0
    loss, metrics = ts.seq2seq_loss(params, tcfg, batch, train=False)
    assert float(metrics["moe_aux"]) > 0
    for k in ("moe_aux", "loss_total", "loss_decoder"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(metrics_j[k]),
                                   err_msg=k, **F32)
    loss.backward()
    got = tree_map(lambda t: t.grad.numpy(), params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, grads_j))):
        np.testing.assert_allclose(a, b, **F32)
    data = {k: np.stack([v]) for k, v in _seq_batch(seed=4).items()}
    state = ttrain.TrainState(params_from_numpy(tree, "cpu"),
                              params_from_numpy(tree, "cpu"), None, 0)
    state = state._replace(opt_state=ttrain.make_optimizer(state.params, 1e-3))
    run = ttrain.make_segment_runner(tcfg, {}, 0.99)
    _, means = run(state, {k: torch.from_numpy(v) for k, v in data.items()},
                   np.zeros(1, np.int32), np.array([[0, 2]]), torch.Generator().manual_seed(0), 1)
    assert "moe_aux" in means and float(means["moe_aux"]) > 0


def test_per_row_offsets_set_validity_per_row():
    """A (B,) offset tensor (the serving pool's windows) under 'dense': each
    row equals its own encode at its scalar offset, capacity path included
    (positions below 0 or past a row's length take no slot)."""
    jcc, tcfg = _configs(1.0, 8, num_blocks=1, attention_impl="dense")
    params = tc.init_conformer(torch.Generator().manual_seed(0), tcfg, 6, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 6)).astype(np.float32))
    offsets = torch.tensor([-8, 4])
    lengths = torch.tensor([5, 14], dtype=torch.int32)
    out, _, stats = tc.conformer_encode(params, tcfg, x, lengths, position_offset=offsets,
                                        mask_invalid=True, return_moe_stats=True)
    n = 0
    for b in range(2):
        want, _, s = tc.conformer_encode(params, tcfg, x[b:b + 1], lengths[b:b + 1],
                                         position_offset=int(offsets[b]), mask_invalid=True,
                                         return_moe_stats=True)
        np.testing.assert_allclose(out[b].numpy(), want[0].numpy(), **F32)
        n += float(s[0]["n"])
    assert float(stats[0]["n"]) == n == (5 - 0) + (14 - 4)


def test_moe_stream_equals_offline_and_capacity_refused():
    """No-drop MoE: ``ConformerStream`` chunks (the last partial) equal the
    offline encode's valid rows; the capacity path refuses to stream."""
    _, tcfg = _configs(attention_impl="flash")
    params = tc.init_conformer(torch.Generator().manual_seed(0), tcfg, 6, device="cpu")
    C = tcfg.chunk_size
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 5 * C, 6)).astype(np.float32))
    n_valid = 4 * C + 2
    stream = tc.ConformerStream(params, tcfg)
    outs = [stream.push(x[:, i * C:(i + 1) * C], n_valid - 4 * C if i == 4 else None)
            for i in range(5)]
    offline, _ = tc.conformer_encode(params, tcfg, x, torch.tensor([n_valid]))
    got = torch.cat(outs, dim=1)[:, :n_valid]
    np.testing.assert_allclose(got.numpy(), offline[:, :n_valid].numpy(), **F32)
    with pytest.raises(ValueError, match="no-drop"):
        tc.ConformerStream(params, _configs(1.25, 8)[1])
