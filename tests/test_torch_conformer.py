"""The port's conformer family held to the JAX package at small sizes.

``conformer_encode`` under every attention implementation (dense,
banded, flash through the K2f/K2b plain versions, fused through K3f's),
with remat on and off: outputs and every parameter gradient against
``jax.grad`` of the JAX encoder on the same parameters
(``params_from_numpy``) and numpy inputs; bf16 outputs of each kernel
path against JAX's same path; ``ConformerStream`` against JAX's stream
and against the offline encode; the seq2seq conformer family (``encode``,
``seq2seq_loss`` with every gradient leaf, ``greedy_decode`` and the
``OnlinePredictor`` tokens); one segment of the segment runner; and
``MultiSubjectTrainer`` building, fitting and serving a conformer on the
demo experiment.  Rows past a sequence's length are garbage in both
packages and are not compared.  Tolerances: f32 rtol 1e-4 / atol 1e-5,
bf16 rtol 5e-2 / atol 2e-2, unless a test says why it needs more.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecog2txt_tpu import serve as jserve
from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.models import conformer as jc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_leaves, tree_map
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models import seq2seq as ts
from ecog2txt_tpu_torch.serve import OnlinePredictor
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
CFG = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
           chunk_size=8, left_context=1)
B, T, IN = 2, 50, 12
LENGTHS = np.array([50, 37], np.int32)
VALID = (np.arange(T)[None] < LENGTHS[:, None])[..., None]


def _assert_trees_close(got, want, tol=F32, path="params"):
    """``got`` a torch tree, ``want`` the same tree with numpy leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{path}/{i}")
    else:
        assert tuple(got.shape) == tuple(np.shape(want)), path
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), err_msg=path, **tol)


def _port_init(init, *args):
    """Parameters drawn by the port's initialiser (seed 0) as a numpy
    tree, to feed both packages: the JAX initialisers run op by op
    outside ``jit`` and cost seconds; their layout is held to the port's
    in ``test_params_carry_across_and_predictor_serves``."""
    return tree_map(lambda t: t.numpy(), init(*args))


def _masked(a, valid=VALID):
    a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    return np.where(valid, a, 0)


@functools.lru_cache(maxsize=None)
def _jax_encoder():
    """JAX's encoder (dense attention, f32): parameters, inputs, output
    and the gradient of ``sum(out * cot)`` (one compile)."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((B, T, IN)).astype(np.float32)
    cot = np.where(VALID, rng.standard_normal((B, T, CFG["model_dim"])), 0).astype(np.float32)
    cfg = jc.ConformerConfig(**CFG, attention_impl="dense")
    params = _port_init(tc.init_conformer, torch.Generator().manual_seed(0),
                        tc.ConformerConfig(**CFG), IN, "cpu")

    def loss(p):
        out, _ = jc.conformer_encode(p, cfg, jnp.asarray(xs), jnp.asarray(LENGTHS))
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return jax.tree.map(np.asarray, (params, out, grads)) + (xs, cot)


@pytest.mark.parametrize("impl,remat", [
    ("dense", False), ("banded", True), ("flash", False), ("flash", True),
    ("fused", False), ("fused", True),
])
def test_conformer_encode_matches_jax(impl, remat):
    """Every attention implementation computes the JAX encoder's function:
    output on valid rows and every parameter gradient, f32."""
    tree, out_j, grads_j, xs, cot = _jax_encoder()
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    cfg = tc.ConformerConfig(**CFG, attention_impl=impl, remat=remat)
    out, carry = tc.conformer_encode(params, cfg, torch.from_numpy(xs),
                                     torch.from_numpy(LENGTHS))
    assert len(carry) == CFG["num_blocks"]
    np.testing.assert_allclose(_masked(out), _masked(out_j), **F32)
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_trees_close(tree_map(lambda t: t.grad, params), grads_j)


@pytest.mark.parametrize("impl", ["dense", "flash", "fused"])
def test_conformer_encode_bf16_matches_jax(impl):
    """bf16 streams: each path against JAX's same path (their rounding
    points differ between paths, not between packages)."""
    tree, _, _, xs, _ = _jax_encoder()
    cfg = jc.ConformerConfig(**CFG, attention_impl=impl)
    want = jax.jit(lambda p: jc.conformer_encode(
        p, cfg, jnp.asarray(xs), jnp.asarray(LENGTHS), compute_dtype=jnp.bfloat16
    )[0])(jax.tree.map(jnp.asarray, tree))
    got, _ = tc.conformer_encode(
        params_from_numpy(tree, "cpu"), tc.ConformerConfig(**CFG, attention_impl=impl),
        torch.from_numpy(xs), torch.from_numpy(LENGTHS), compute_dtype=torch.bfloat16,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_masked(got), _masked(want), **BF16)


def test_auto_dispatch_and_config(monkeypatch):
    """'auto' runs dense up to 256 steps and banded beyond on a CPU
    tensor; a MoE config builds, and its parameter tree has the JAX
    tree's keys and shapes (the MoE function is held to JAX in
    ``tests/test_torch_moe.py``)."""
    seen = []
    for impl in ("dense", "banded"):
        orig = tc._ATTENTION_IMPLS[impl]
        monkeypatch.setitem(tc._ATTENTION_IMPLS, impl,
                            lambda *a, _o=orig, _i=impl: seen.append(_i) or _o(*a))
    cfg = tc.ConformerConfig(num_blocks=1, model_dim=8, num_heads=2, ffn_dim=8,
                             conv_kernel=2, chunk_size=16)
    params = tc.init_conformer(torch.Generator().manual_seed(0), cfg, 4, device="cpu")
    for steps in (256, 257):
        tc.conformer_encode(params, cfg, torch.zeros((1, steps, 4)))
    assert seen == ["dense", "banded"]
    moe = dict(num_blocks=1, model_dim=8, num_heads=2, ffn_dim=8, conv_kernel=2,
               chunk_size=16, moe_experts=4, moe_topk=2)
    own = tc.init_conformer(torch.Generator().manual_seed(0), tc.ConformerConfig(**moe), 4,
                            device="cpu")
    want = jax.eval_shape(lambda: jc.init_conformer(
        jax.random.PRNGKey(0), jc.ConformerConfig(**moe), 4))
    assert jax.tree.map(np.shape, tree_map(lambda t: t.numpy(), own)) == jax.tree.map(
        lambda a: a.shape, want)
    assert tuple(own["blocks"][0]["ffn2"]["w1"].shape) == (4, 8, 8)
    assert tc.receptive_field_steps(tc.ConformerConfig(**CFG)) == jc.receptive_field_steps(
        jc.ConformerConfig(**CFG)
    )


def test_conformer_stream_matches_jax_and_offline():
    """Pushes of 8-step chunks (the last one partial, 3 valid steps)
    through the flash path: each emitted chunk equals JAX's stream and
    the port's offline encode of the whole utterance on its valid rows."""
    tree, _, _, _, _ = _jax_encoder()
    rng = np.random.default_rng(5)
    C = CFG["chunk_size"]
    chunks = rng.standard_normal((5, 1, C, IN)).astype(np.float32)
    n_valid = 4 * C + 3
    jstream = jc.ConformerStream(jax.tree.map(jnp.asarray, tree),
                                 jc.ConformerConfig(**CFG, attention_impl="flash"))
    cfg = tc.ConformerConfig(**CFG, attention_impl="flash")
    params = params_from_numpy(tree, "cpu")
    tstream = tc.ConformerStream(params, cfg)
    offline, _ = tc.conformer_encode(
        params, cfg, torch.from_numpy(chunks[:, 0].reshape(1, 5 * C, IN)),
        torch.tensor([n_valid], dtype=torch.int32),
    )
    for i, chunk in enumerate(chunks):
        nv = 3 if i == 4 else None
        got = tstream.push(torch.from_numpy(chunk), nv)
        want = jstream.push(jnp.asarray(chunk), nv)
        rows = np.arange(C)[None, :, None] < (nv or C)
        np.testing.assert_allclose(_masked(got, rows), _masked(want, rows), **F32)
        np.testing.assert_allclose(
            _masked(got, rows), _masked(offline[:, i * C:(i + 1) * C], rows), **F32
        )
    with pytest.raises(RuntimeError, match="partial"):
        tstream.push(torch.from_numpy(chunks[0]))
    state = tstream.snapshot()
    tstream.reset()
    tstream.restore(state)
    assert tstream.snapshot() == state


# --------------------------------------------------------------------------
# the seq2seq conformer family
# --------------------------------------------------------------------------

SEQ = dict(vocab_size=20, in_channels=5, conv_sizes=(6,), decimation_factor=3,
           aux_proj_sizes=(7,), dec_embedding_size=6, dec_rnn_sizes=(12,),
           max_dec_len=5, encoder_type="conformer")
RAW_T, RAW_LENGTHS = 48, np.array([48, 31, 20], np.int32)
# one block keeps JAX's compiles of the loss and of the segment runner short
CFG1 = {**CFG, "num_blocks": 1}


def _seq_configs(jimpl="dense", timpl="flash", **extra):
    kw = {**SEQ, **extra}
    jcfg = js.Seq2SeqConfig(
        **kw, aux_heads=(js.AuxHead("aux", "categorical", 4),),
        conformer=jc.ConformerConfig(**CFG1, attention_impl=jimpl),
    )
    tcfg = ts.Seq2SeqConfig(
        **kw, aux_heads=(ts.AuxHead("aux", "categorical", 4),),
        conformer=tc.ConformerConfig(**CFG1, attention_impl=timpl),
    )
    return jcfg, tcfg


def _seq_batch(seed=0, n=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 6, size=n).astype(np.int32)
    dec = rng.integers(3, 20, size=(n, 5)).astype(np.int32)
    pos = np.arange(5)
    dec = np.where(pos == lens[:, None] - 1, 1, dec)
    dec = np.where(pos >= lens[:, None], 0, dec).astype(np.int32)
    return {
        "encoder_inputs": rng.normal(size=(n, RAW_T, 5)).astype(np.float32),
        "encoder_lengths": (RAW_LENGTHS if n == 3 else
                            rng.integers(20, RAW_T + 1, size=n)).astype(np.int32),
        "decoder_targets": dec,
        "decoder_lengths": lens,
        "aux": rng.integers(0, 4, size=(n, RAW_T)).astype(np.int32),
    }


@functools.lru_cache(maxsize=None)
def _jax_seq2seq():
    """JAX's conformer seq2seq: params, loss, metrics and gradients at
    train=False, the encoder's outputs and greedy tokens (compiled once
    each)."""
    jcfg, tcfg = _seq_configs()
    jp = _port_init(ts.init_seq2seq, tcfg, torch.Generator().manual_seed(0), "cpu")
    jb = {k: jnp.asarray(v) for k, v in _seq_batch().items()}
    jb["subject_idx"] = jnp.asarray(0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: js.seq2seq_loss(p, jcfg, jb, jax.random.PRNGKey(0), train=False),
        has_aux=True,
    ))(jp)

    @jax.jit
    def enc_and_greedy(p, x, lens):
        out, final, enc_lengths = js.encode(p, jcfg, x, lens, 0, jax.random.PRNGKey(0))
        return out, final[0], enc_lengths, js.greedy_decode(p, jcfg, x, lens, 0)

    enc = enc_and_greedy(jp, jb["encoder_inputs"], jb["encoder_lengths"])
    return jax.tree.map(np.asarray, (jp, loss, metrics, grads, enc))


def test_seq2seq_conformer_matches_jax():
    """``encode`` (masked outputs, masked-mean final state, lengths),
    ``seq2seq_loss`` and every gradient leaf at train=False, and
    ``greedy_decode`` tokens, the port's flash path against JAX's dense
    path (the same function)."""
    tree, loss_j, metrics_j, grads_j, (out_j, pooled_j, elen_j, tokens_j) = _jax_seq2seq()
    _, tcfg = _seq_configs()
    assert tcfg.enc_out_dim == CFG["model_dim"]
    params = tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _seq_batch().items()}
    batch["subject_idx"] = 0
    out, (h, c), elen = ts.encode(params, tcfg, batch["encoder_inputs"],
                                  batch["encoder_lengths"], 0)
    np.testing.assert_array_equal(elen.numpy(), elen_j)
    np.testing.assert_allclose(out.detach().numpy(), out_j, **F32)
    np.testing.assert_allclose(h.detach().numpy(), pooled_j, **F32)
    assert h is c
    loss, metrics = ts.seq2seq_loss(params, tcfg, batch, train=False)
    loss.backward()
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k].detach()), float(metrics_j[k]),
                                   err_msg=k, **F32)
    _assert_trees_close(tree_map(lambda t: t.grad, params), grads_j)
    with torch.no_grad():
        tokens = ts.greedy_decode(params, tcfg, batch["encoder_inputs"],
                                  batch["encoder_lengths"], 0)
    np.testing.assert_array_equal(tokens.numpy(), tokens_j)


def test_params_carry_across_and_predictor_serves():
    """A JAX ``init_seq2seq(encoder_type='conformer')`` tree and the
    port's own init have the same keys, nesting and shapes, and
    ``params_from_numpy`` carries the JAX leaves across unchanged; the
    port's ``OnlinePredictor`` serves the conformer model with the JAX
    predictor's tokens and probabilities."""
    jcfg, tcfg = _seq_configs(timpl="fused")
    tree = jax.tree.map(np.asarray, jax.jit(js.init_seq2seq, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    own = _port_init(ts.init_seq2seq, tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shapes(own) == shapes(tree)
    carried = params_from_numpy(tree, "cpu")
    for a, b in zip(tree_leaves(carried), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 20)]
    x = np.random.default_rng(7).normal(size=(2, 40, 5)).astype(np.float32)
    want = jserve.OnlinePredictor(jax.tree.map(jnp.asarray, tree), jcfg, targets,
                                  max_samples=RAW_T)(x)
    got = OnlinePredictor(carried, tcfg, targets, max_samples=RAW_T, device="cpu")(x)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], **F32)
    assert got["sequences"] == want["sequences"]


def test_segment_runner_conformer_matches_jax():
    """One 3-step segment over two subjects at dropout 0, the port's
    fused path (K3f forward, K2b and plain products backward) against
    JAX's dense path: mean loss, params and EMA after the segment.
    Params and EMA get atol 1e-4 (lr / 100): Adam divides each gradient
    by its running RMS, so summation-order noise in a small gradient
    moves its element by a visible fraction of the learning rate (the
    reason ``tests/test_torch_train.py`` states for the same bound)."""
    jcfg, tcfg = _seq_configs(timpl="fused", FF_dropout=0.0, RNN_dropout=0.0,
                              num_subjects=2)
    lr, decay = 1e-2, 0.9
    scales = {"aux": 1.0, "decoder_targets": 1.0}
    tree = _port_init(ts.init_seq2seq, tcfg, torch.Generator().manual_seed(1), "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    data = {k: np.stack([v, _seq_batch(seed=9, n=4)[k]])
            for k, v in _seq_batch(seed=8, n=4).items()}
    subjects = np.array([0, 1, 0], np.int32)
    idx = np.array([[0, 3], [1, 2], [3, 1]], np.int32)
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    jstate = jtrain.TrainState(jp, jax.tree.map(jnp.copy, jp), optimizer.init(jp),
                               jnp.asarray(0, jnp.int32))
    jrun = jtrain.make_segment_runner(jcfg, optimizer, scales, decay)
    jstate, jmetrics = jrun(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                            subjects, idx, jax.random.PRNGKey(0), 1)
    tp = params_from_numpy(tree, "cpu")
    tstate = ttrain.TrainState(tp, tree_map(lambda t: t.clone(), tp),
                               ttrain.make_optimizer(tp, lr), 0)
    trun = ttrain.make_segment_runner(tcfg, scales, decay)
    tstate, tmetrics = trun(tstate, {k: torch.from_numpy(v) for k, v in data.items()},
                            subjects, idx, torch.Generator().manual_seed(0), 1)
    np.testing.assert_allclose(float(tmetrics["loss_total"]),
                               float(jmetrics["loss_total"]), **F32)
    tol = dict(rtol=1e-4, atol=1e-4)
    _assert_trees_close(tstate.params, jax.tree.map(np.asarray, jstate.params), tol)
    _assert_trees_close(tstate.ema, jax.tree.map(np.asarray, jstate.ema), tol)


def test_trainer_fits_and_serves_a_conformer(tmp_path):
    """``MultiSubjectTrainer`` maps ``SN_kwargs['conformer']`` to a
    ``ConformerConfig``, fits the demo experiment for a few epochs with
    finite losses, and serves through ``OnlinePredictor.from_trainer``."""
    tiny = {"encoder_embedding": [24], "encoder_1_projection": [24],
            "decoder_embedding": [16], "decoder_rnn": [32], "decoder_projection": []}
    mp = tdemo.make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,),
                                    layer_sizes=tiny, N_epochs=4)
    conformer = dict(num_blocks=1, model_dim=16, num_heads=2, ffn_dim=32,
                     conv_kernel=4, chunk_size=4, left_context=1,
                     attention_impl="fused")
    tr = ttrain.MultiSubjectTrainer(
        mp, [1], VERBOSE=False, device="cpu",
        SN_kwargs={"encoder_type": "conformer", "conformer": conformer,
                   "batch_size": 16, "max_dec_len": 6, "learning_rate": 3e-3},
    )
    assert tr.net_config.conformer == tc.ConformerConfig(**conformer)
    assert "conformer" in tr.state.params["encoder"]
    before = [t.detach().clone() for t in tree_leaves(tr.state.params)]
    history = tr.fit(num_epochs=4)
    assert tr.state.epoch == 4 and history
    moved = [not torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.state.params))]
    assert all(moved), "every parameter leaf should train"
    predictor = OnlinePredictor.from_trainer(tr)
    val = tr.packed_dataset("validation")
    out = predictor(val.encoder_inputs[0, 0, : int(val.encoder_lengths[0, 0])])
    assert out["tokens"].shape == (1, 6) and np.isfinite(out["probabilities"]).all()
    # sequence and tensor parallelism need the ranks of a torch.distributed
    # world (tests/test_torch_parallel_dist.py, tests/test_torch_tp_pp_dist.py)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ttrain.MultiSubjectTrainer(
            mp, [1], VERBOSE=False, device="cpu",
            SN_kwargs={"encoder_type": "conformer", "conformer": conformer,
                       "sequence_parallel": 2})
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ttrain.MultiSubjectTrainer(mp, [1], SN_kwargs={"tensor_parallel": 2},
                                   VERBOSE=False, device="cpu")
