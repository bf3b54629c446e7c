"""The port's one-launch biLSTM grid (K4f, K4b) held to JAX.

The plain versions of K4f and K4b (what the port runs on a CPU tensor)
against the Pallas grid kernels ``_bi_grid_fwd_call`` /
``_bi_grid_bwd_call`` in interpret mode; ``fused_bilstm_grid`` (forward
K4f, backward K4b) against ``jax.grad`` of JAX's ``fused_bilstm_grid``;
``bidirectional_lstm(use_pallas='bi_grid')``, ``encode`` and
``seq2seq_loss`` with ``use_pallas_lstm='bi_grid'`` against the JAX
package's step loops; the trainer's handling of the option.  Inputs come
from a numpy seed, parameters through ``convert.params_from_numpy``.
Tolerances: f32 rtol 1e-4 / atol 1e-5 (only the order of f32 sums
differs); bf16 rtol 5e-2 / atol 2e-2 (bf16 outputs may land one bf16
step apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.ops import lstm as jlstm
from ecog2txt_tpu.ops.pallas_lstm import _bi_grid_bwd_call, _bi_grid_fwd_call
from ecog2txt_tpu.ops.pallas_lstm import fused_bilstm_grid as jgrid
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_leaves, tree_map
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.ops import lstm as tlstm
from ecog2txt_tpu_torch.ops import lstm_kernels
from torch_threads import one_torch_thread  # noqa: F401

T, B, F, H = 7, 3, 6, 16
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
TOL = {"float32": F32, "bfloat16": BF16}
LENGTHS = np.array([T, 4, 2], np.int32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _grid_inputs(rng, dtype, variant):
    """xwf, xwb, whf, whb, lengths, maskf, maskb as numpy (stream arrays
    exact in bf16 when ``dtype`` is bf16)."""
    xw = [(rng.normal(size=(T, B, 4 * H)) * 0.7).astype(np.float32) for _ in "fb"]
    wh = [(rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in "fb"]
    if dtype == "bfloat16":
        xw, wh = [_bf16_exact(a) for a in xw], [_bf16_exact(a) for a in wh]
    if variant == "full":
        lengths = np.full((B,), T, np.int32)
        masks = [np.ones((B, H), np.float32) for _ in "fb"]
    else:
        lengths = LENGTHS
        masks = [(rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32) for _ in "fb"]
    return (*xw, *wh, lengths, *masks)


def _to_torch(arrays, dtype, stream_idx):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt) if i in stream_idx else torch.from_numpy(a)
            for i, a in enumerate(arrays)]


def _to_jax(arrays, dtype, stream_idx):
    jdt = getattr(jnp, dtype)
    return [jnp.asarray(a, jdt) if i in stream_idx else jnp.asarray(a)
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["full", "ragged_mask"])
def test_plain_k4f_matches_pallas(dtype, variant):
    a = _grid_inputs(np.random.default_rng(1), dtype, variant)
    stream = (0, 1, 2, 3)
    want = _bi_grid_fwd_call(*_to_jax(a, dtype, stream), True)
    got = lstm_kernels.bilstm_grid_fwd(*_to_torch(a, dtype, stream))
    assert lstm_kernels.bilstm_grid_fwd.launches == 0
    assert [g.dtype for g in got] == [getattr(torch, dtype)] * 4 + [torch.float32] * 2
    names = ("hf", "hb", "cf", "cb", "hT", "cT")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])
    # the reverse chain's outputs past each length are exactly zero
    for b, n in enumerate(a[4]):
        assert not _np(got[1])[n:, b].any() and not _np(got[0])[n:, b].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["full", "ragged_mask"])
def test_plain_k4b_matches_pallas(dtype, variant):
    """The adjoint on residuals of a real forward pass, with nonzero
    upstream gradients for h_seq and both final states."""
    rng = np.random.default_rng(2)
    a = _grid_inputs(rng, dtype, variant)
    xwf, xwb, whf, whb, lengths, maskf, maskb = _to_torch(a, dtype, (0, 1, 2, 3))
    hf, hb, cf, cb, _, _ = lstm_kernels.bilstm_grid_fwd_reference(
        xwf, xwb, whf, whb, lengths, maskf, maskb
    )
    zeros = torch.zeros((B, H))
    hpf, cpf = (lstm_kernels._shifted(s, zeros, False) for s in (hf, cf))
    hpb, cpb = (lstm_kernels._shifted(s, zeros, True) for s in (hb, cb))
    res = [_np(t) for t in (hpf, hpb, cpf, cpb, cf, cb)]
    if dtype == "bfloat16":
        res = [_bf16_exact(r) for r in res]
    dhs = [rng.normal(size=(T, B, H)).astype(np.float32) for _ in "fb"]
    if dtype == "bfloat16":
        dhs = [_bf16_exact(d) for d in dhs]
    dhT, dcT = (rng.normal(size=(2, B, H)).astype(np.float32) for _ in "hc")
    arrays = [*a[:4], *res, a[4], a[5], a[6], *dhs, dhT, dcT]
    stream = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 14)
    want = _bi_grid_bwd_call(*_to_jax(arrays, dtype, stream), True)
    got = lstm_kernels.bilstm_grid_bwd(*_to_torch(arrays, dtype, stream))
    assert lstm_kernels.bilstm_grid_bwd.launches == 0
    assert [g.dtype for g in got] == [getattr(torch, dtype)] * 2 + [torch.float32] * 2
    for name, g, w in zip(("dgf", "dgb", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bilstm_grid_values_and_gradients_match_jax(dtype):
    """(h_seq, hT, cT) and dL/d(xwf, xwb, whf, whb) through forward K4f +
    backward K4b, against JAX's ``fused_bilstm_grid`` and ``jax.grad`` of
    it (interpret mode; its VJP runs two ``_bwd_call`` launches).  The
    loss reads the output sequence and both final states."""
    rng = np.random.default_rng(3)
    xwf, xwb, whf, whb, lengths, maskf, maskb = _grid_inputs(rng, dtype, "ragged_mask")
    w_out = rng.normal(size=(2 * H,)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jloss(xwf, xwb, whf, whb):
        out, hT, cT = jgrid(xwf.astype(jdt), xwb.astype(jdt), whf, whb,
                            jnp.asarray(lengths), jnp.asarray(maskf),
                            jnp.asarray(maskb), True)
        return (jnp.sum(out.astype(jnp.float32) * w_out) + 2.0 * jnp.sum(hT)
                + 0.5 * jnp.sum(cT ** 2)), (out, hT, cT)

    (_, jout), want = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(v) for v in (xwf, xwb, whf, whb))
    )
    leaves = [torch.from_numpy(v).requires_grad_() for v in (xwf, xwb, whf, whb)]
    tdt = getattr(torch, dtype)
    out, hT, cT = lstm_kernels.fused_bilstm_grid(
        leaves[0].to(tdt), leaves[1].to(tdt), leaves[2], leaves[3],
        torch.from_numpy(lengths), torch.from_numpy(maskf), torch.from_numpy(maskb),
    )
    assert out.dtype == tdt and hT.dtype == cT.dtype == torch.float32
    for name, g, w in zip(("h_seq", "hT", "cT"), (out, hT, cT), jout):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])
    loss = ((out.float() * torch.from_numpy(w_out)).sum() + 2.0 * hT.sum()
            + 0.5 * (cT ** 2).sum())
    loss.backward()
    # the recurrent weights' gradients reach the f32 parameters in f32
    assert leaves[2].grad.dtype == leaves[3].grad.dtype == torch.float32
    for name, g, w in zip(("xwf", "xwb", "whf", "whb"), leaves, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), err_msg=name, **TOL[dtype])


def test_serving_runs_k4f_alone_without_c_seq(monkeypatch):
    """Without a gradient to compute, the grid asks K4f for no ``c_seq``
    and never reaches the adjoint; under autograd it saves ``c_seq``."""
    asked = []
    real = lstm_kernels.bilstm_grid_fwd

    def spy(*args, **kwargs):
        asked.append(kwargs.get("return_c_seq", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(lstm_kernels, "bilstm_grid_fwd", spy)
    a = _to_torch(_grid_inputs(np.random.default_rng(4), "float32", "ragged_mask"),
                  "float32", ())
    with torch.inference_mode():
        lstm_kernels.fused_bilstm_grid(*a)
    assert asked == [False]
    out, _, _ = lstm_kernels.fused_bilstm_grid(a[0].requires_grad_(), *a[1:])
    assert asked == [False, True] and out.requires_grad


@pytest.mark.parametrize("bad", ["xwb_dtype", "wh_shape", "mask_dtype", "dhT_shape"])
def test_grid_wrappers_reject_what_the_kernels_do_not_take(bad):
    a = _to_torch(_grid_inputs(np.random.default_rng(5), "float32", "full"), "float32", ())
    if bad == "dhT_shape":
        seq = torch.zeros((T, B, H))
        args = (*a[:4], seq, seq, seq, seq, seq, seq, *a[4:], seq, seq,
                torch.zeros((B, H)), torch.zeros((2, B, H)))
        with pytest.raises(ValueError):
            lstm_kernels.bilstm_grid_bwd(*args)
        return
    if bad == "xwb_dtype":
        a[1] = a[1].bfloat16()
    elif bad == "wh_shape":
        a[3] = a[3][:-1]
    else:
        a[6] = a[6].double()
    with pytest.raises((TypeError, ValueError)):
        lstm_kernels.bilstm_grid_fwd(*a)


def _layer_params():
    jf = jlstm.init_lstm_params(jax.random.PRNGKey(0), F, H)
    jb = jlstm.init_lstm_params(jax.random.PRNGKey(1), F, H)
    tf, tb = (params_from_numpy(jax.tree.map(np.asarray, p), device="cpu") for p in (jf, jb))
    return jf, jb, tf, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_bi_grid_matches_jax(dtype):
    """A biLSTM layer under ``use_pallas='bi_grid'`` with recurrent
    dropout masks: outputs, final states and every gradient against the
    JAX layer (f32: its step loops; bf16: its per-direction Pallas path
    in interpret mode, which streams bf16 as the grid does)."""
    jf, jb, tf, tb = _layer_params()
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(T, B, F)).astype(np.float32)
    masks = [(rng.integers(0, 2, size=(B, H)) * 2.0).astype(np.float32) for _ in "fb"]
    w_out = rng.normal(size=(2 * H,)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jax_pallas = dtype == "bfloat16"

    def jloss(pf, pb, xs):
        out, (h, c) = jlstm.bidirectional_lstm(
            pf, pb, xs, jnp.asarray(LENGTHS), tuple(map(jnp.asarray, masks)), jdt,
            use_pallas=jax_pallas, pallas_interpret=True,
        )
        return jnp.sum(out.astype(jnp.float32) * w_out) + jnp.sum(h) + jnp.sum(c), (out, h, c)

    (_, jout), want = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jf, jb, jnp.asarray(xs))
    for p in (tf, tb):
        for v in p.values():
            v.requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    out, (h, c) = tlstm.bidirectional_lstm(
        tf, tb, x, torch.from_numpy(LENGTHS), tuple(map(torch.from_numpy, masks)),
        getattr(torch, dtype), use_pallas="bi_grid",
    )
    for name, g, w in zip(("outputs", "h", "c"), (out, h, c), jout):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])
    loss = (out.float() * torch.from_numpy(w_out)).sum() + h.sum() + c.sum()
    loss.backward()
    for name, p, jp in (("fwd", tf, want[0]), ("bwd", tb, want[1])):
        for k in ("wx", "wh", "b"):
            assert p[k].grad.dtype == torch.float32
            np.testing.assert_allclose(_np(p[k].grad), np.asarray(jp[k]),
                                       err_msg=f"{name} {k}", **TOL[dtype])
    np.testing.assert_allclose(_np(x.grad), np.asarray(want[2]), **TOL[dtype])


def test_use_pallas_values():
    """False, True and 'bi_grid' are taken; anything else raises.  For one
    direction ``lstm_scan`` treats 'bi_grid' as True."""
    _, _, tf, tb = _layer_params()
    xs = torch.from_numpy(np.random.default_rng(7).normal(size=(T, B, F)).astype(np.float32))
    lens = torch.from_numpy(LENGTHS)
    out_t, (h_t, _) = tlstm.lstm_scan(tf, xs, lens, use_pallas=True)
    out_g, (h_g, _) = tlstm.lstm_scan(tf, xs, lens, use_pallas="bi_grid")
    assert torch.equal(out_t, out_g) and torch.equal(h_t, h_g)
    for bad in ("bigrid", "True", 1, None):
        with pytest.raises(ValueError, match="use_pallas"):
            tlstm.bidirectional_lstm(tf, tb, xs, lens, use_pallas=bad)
        with pytest.raises(ValueError, match="use_pallas"):
            tlstm.lstm_scan(tf, xs, lens, use_pallas=bad)
    with pytest.raises(ValueError, match="use_pallas"):
        ts.Seq2SeqConfig(vocab_size=20, use_pallas_lstm="grid")


B2, T2, C2 = 3, 24, 5
LENGTHS2 = np.array([24, 17, 9], np.int32)
SEQ_KW = dict(vocab_size=20, in_channels=C2, conv_sizes=(6,), decimation_factor=3,
              rnn_sizes=(8, 8), aux_proj_sizes=(7,), dec_embedding_size=6,
              dec_rnn_sizes=(12,), max_dec_len=5)


def test_encode_and_loss_bi_grid_match_jax():
    """``encode`` and ``seq2seq_loss`` (value and every gradient leaf, at
    train=False) with ``use_pallas_lstm='bi_grid'`` against the JAX
    package's step-loop model, f32.  The parameters are drawn by the
    port's initialiser and handed to both as one numpy tree."""
    jcfg = js.Seq2SeqConfig(**SEQ_KW, aux_heads=(js.AuxHead("aux", "categorical", 4),))
    tcfg = ts.Seq2SeqConfig(**SEQ_KW, aux_heads=(ts.AuxHead("aux", "categorical", 4),),
                            use_pallas_lstm="bi_grid")
    tree = tree_map(lambda t: t.numpy(),
                    ts.init_seq2seq(tcfg, torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B2, T2, C2)).astype(np.float32)
    dec_len = rng.integers(2, 6, size=B2).astype(np.int32)
    dec = rng.integers(3, 20, size=(B2, 5)).astype(np.int32)
    pos = np.arange(5)
    dec = np.where(pos == dec_len[:, None] - 1, 1, dec)
    dec = np.where(pos >= dec_len[:, None], 0, dec).astype(np.int32)
    batch = {"encoder_inputs": x, "encoder_lengths": LENGTHS2, "decoder_targets": dec,
             "decoder_lengths": dec_len,
             "aux": rng.integers(0, 4, size=(B2, T2)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["subject_idx"] = jnp.asarray(0)
    scales = {"aux": 0.5, "decoder_targets": 1.0}

    @jax.jit
    def jax_side(p):
        enc = js.encode(p, jcfg, jb["encoder_inputs"], jb["encoder_lengths"], 0,
                        jax.random.PRNGKey(0))
        (loss, _), grads = jax.value_and_grad(
            lambda q: js.seq2seq_loss(q, jcfg, jb, jax.random.PRNGKey(0), train=False,
                                      penalty_scales=scales), has_aux=True)(p)
        return enc, loss, grads

    (oj, (hj, cj), _), jloss, jgrads = jax_side(tree)
    tp = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["subject_idx"] = 0
    with torch.no_grad():
        ot, (ht, ct), _ = ts.encode(tp, tcfg, tb["encoder_inputs"], tb["encoder_lengths"], 0)
    for name, g, w in (("outputs", ot, oj), ("h", ht, hj), ("c", ct, cj)):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **F32)
    tloss, _ = ts.seq2seq_loss(tp, tcfg, tb, train=False, penalty_scales=scales)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **F32)
    flat_t = jax.tree_util.tree_leaves(tree_map(lambda t: t.grad.numpy(), tp))
    flat_j = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jgrads))
    assert len(flat_t) == len(flat_j)
    for i, (g, w) in enumerate(zip(flat_t, flat_j)):
        np.testing.assert_allclose(g, w, err_msg=f"gradient leaf {i}", **F32)


def test_predictor_serves_bi_grid_as_the_per_direction_path():
    """``OnlinePredictor`` under 'bi_grid' returns the tokens and
    probabilities of the per-direction kernel path (True): the two run
    the same function (on the CPU, the same plain step loops)."""
    from ecog2txt_tpu_torch.serve import OnlinePredictor

    tcfg = ts.Seq2SeqConfig(**SEQ_KW, aux_heads=(), use_pallas_lstm="bi_grid")
    params = ts.init_seq2seq(tcfg, torch.Generator().manual_seed(1), "cpu")
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 20)]
    x = np.random.default_rng(9).normal(size=(2, T2, C2)).astype(np.float32)
    outs = [OnlinePredictor(params, dataclasses.replace(tcfg, use_pallas_lstm=v), targets,
                            max_samples=T2, device="cpu")(x)
            for v in ("bi_grid", True)]
    np.testing.assert_array_equal(outs[0]["tokens"], outs[1]["tokens"])
    np.testing.assert_allclose(outs[0]["probabilities"], outs[1]["probabilities"], **F32)


def test_trainer_takes_bi_grid_and_rejects_an_unknown_value(tmp_path):
    """``SN_kwargs={'use_pallas_lstm': 'bi_grid'}`` reaches the model
    config unchanged (no coercion to a bool), a segment trains on it, and
    an unknown value raises."""
    mp = tdemo.make_demo_experiment(
        str(tmp_path / "exp"), subject_ids=(1,), N_epochs=1,
        layer_sizes={"encoder_embedding": [8], "encoder_rnn": [8],
                     "encoder_1_projection": [8], "decoder_embedding": [8],
                     "decoder_rnn": [16], "decoder_projection": []},
    )
    sn = {"batch_size": 16, "max_dec_len": 10}
    tr = ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={**sn, "use_pallas_lstm": "bi_grid"},
                                    VERBOSE=False, device="cpu")
    assert tr.net_config.use_pallas_lstm == "bi_grid"
    before = tree_leaves(tree_map(lambda t: t.detach().clone(), tr.state.params))
    tr.fit(num_epochs=1, assess=False)
    after = tree_leaves(tr.state.params)
    assert tr.state.epoch == 1
    assert all(bool(torch.isfinite(a).all()) for a in after)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    with pytest.raises(ValueError, match="use_pallas"):
        ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={**sn, "use_pallas_lstm": "grid"},
                                   VERBOSE=False, device="cpu")
