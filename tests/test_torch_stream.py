"""The port's conformer streaming, pool and export held to the JAX package.

The same weights (``convert.params_from_numpy``) and seeded raw packets go
through both packages' ``StreamingConformerSession`` and
``StreamingSessionPool``: tokens exact and encoder outputs at f32 rtol
1e-4 / atol 1e-5 (bf16: rtol 5e-2 / atol 2e-2), the endpoint equal to the
offline ``greedy_decode``, ``decode()`` repeatable mid-stream, ``partial()``
(greedy and lexicon, carried == from scratch) equal, the pool equal to
dedicated sessions under ragged joins and leaves, and the int8 upload's
contract.  Then the per-row position offsets the pool encodes with, the
``torch.export`` round trip on the CPU of the four families JAX exports
(biLSTM, conformer, MoE and capacity MoE) against the live predictor and
JAX's exported program, the serving options, and ``RawVoltageSession`` (raw voltage, float and int16, through
the high-gamma front end): its endpoint equal to the offline decode of
the calibrated offline features and to JAX's raw session, ``decode()``
repeatable mid-stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import features as jfeatures
from ecog2txt_tpu import serve as jserve
from ecog2txt_tpu.models import ctc as jctc
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu.models.conformer import ConformerConfig as JConformer
from ecog2txt_tpu_torch import convert
from ecog2txt_tpu_torch import demo as tdemo
from ecog2txt_tpu_torch import features as tfeatures
from ecog2txt_tpu_torch import quantize as tquantize
from ecog2txt_tpu_torch import serve as tserve
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.models import conformer as tc
from ecog2txt_tpu_torch.models import ctc as tctc
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=2e-2)
CONFORMER = dict(num_blocks=2, model_dim=32, num_heads=2, ffn_dim=64, conv_kernel=4,
                 chunk_size=4, left_context=1)
KW = dict(vocab_size=12, num_subjects=1, in_channels=8, conv_sizes=(16,),
          decimation_factor=4, rnn_sizes=(24,), aux_proj_sizes=(16,),
          dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6,
          encoder_type="conformer")
PHONEMES = [f"p{i}" for i in range(9)]  # + the trailing blank = 10 classes
TARGETS = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(9)]
LEXICON = {"aa": [0, 0], "ab": [0, 1], "b": [1], "ca": [2, 0]}
# 1 kHz raw → 250 Hz features (q = 4), a small bank, as the JAX test's
HG = tfeatures.HighGammaConfig(raw_rate=1000.0, out_rate=250.0, num_bands=4, pad_seconds=0.25,
                               zscore="none")


@pytest.fixture(scope="module")
def model():
    jcfg = js.Seq2SeqConfig(**KW, aux_heads=(js.AuxHead("ph", "CTC", 10),),
                            conformer=JConformer(**CONFORMER))
    jparams = js.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_cfg(impl="auto", dtype=torch.float32):
    return ts.Seq2SeqConfig(
        **KW, aux_heads=(ts.AuxHead("ph", "CTC", 10),), compute_dtype=dtype,
        conformer=tc.ConformerConfig(**CONFORMER, attention_impl=impl),
    )


def _session(tree, impl="auto", dtype=torch.float32, **kw):
    params = convert.params_from_numpy(tree, device="cpu")
    return tserve.StreamingConformerSession(params, _port_cfg(impl, dtype), TARGETS,
                                            device="cpu", **kw)


def _pool(tree, **kw):
    params = convert.params_from_numpy(tree, device="cpu")
    return tserve.StreamingSessionPool(params, _port_cfg(), TARGETS, device="cpu", **kw)


def _offline(tree, raw, impl="auto"):
    """The port's offline greedy decode of one utterance, padded to a
    multiple of the decimation factor."""
    L = len(raw)
    inputs = np.zeros((1, -(-L // 4) * 4, 8), np.float32)
    inputs[0, :L] = raw
    params = convert.params_from_numpy(tree, device="cpu")
    with torch.inference_mode():
        return ts.greedy_decode(params, _port_cfg(impl), torch.from_numpy(inputs),
                                torch.tensor([L]), 0, temperature=0.0).numpy()


def _raw(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)


@pytest.mark.parametrize("impl", ["dense", "banded", "flash", "fused"])
def test_session_matches_jax_and_offline(model, impl):
    jcfg, jparams, tree = model
    raw = _raw(3, 147)  # neither a multiple of d·chunk (16) nor of d (4)
    jsess = jserve.StreamingConformerSession(jparams, jcfg, TARGETS)
    sess = _session(tree, impl)
    jsess.push(raw[:22])
    sess.push(raw[:22])  # one whole chunk and a remainder
    mid1, mid2 = sess.decode(), sess.decode()
    np.testing.assert_array_equal(mid1["tokens"], mid2["tokens"])
    np.testing.assert_array_equal(mid1["tokens"], np.asarray(jsess.decode()["tokens"]))
    for start in range(22, 147, 37):  # ragged arrival after the peek
        jsess.push(raw[start: start + 37])
        sess.push(raw[start: start + 37])
    assert sess.num_samples == 147
    got, want = sess.endpoint(), jsess.endpoint()
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["encoder_outputs"], np.asarray(want["encoder_outputs"]),
                               **F32)
    np.testing.assert_array_equal(got["tokens"], _offline(tree, raw, impl))
    assert got["sequences"] == want["sequences"]
    assert sess.num_samples == 0 and sess.decode()["tokens"] is None


def test_bf16_session_matches_jax(model):
    jcfg, jparams, tree = model
    jcfg16 = js.Seq2SeqConfig(**{**jcfg.__dict__, "compute_dtype": jnp.bfloat16})
    raw = _raw(5, 100)
    jsess = jserve.StreamingConformerSession(jparams, jcfg16, TARGETS)
    sess = _session(tree, "flash", torch.bfloat16)
    assert sess._upload("probe", np.zeros((1, 2, 3), np.float32),
                        tserve._host_input_dtype(sess.config)).dtype == torch.bfloat16
    for start in range(0, 100, 29):
        jsess.push(raw[start: start + 29])
        sess.push(raw[start: start + 29])
    got, want = sess.decode(), jsess.decode()
    np.testing.assert_allclose(got["encoder_outputs"],
                               np.asarray(want["encoder_outputs"], np.float32), **BF16)


def test_partial_matches_jax(model):
    jcfg, jparams, tree = model
    raw = _raw(11, 96)  # 6 whole chunks
    jsess = jserve.StreamingConformerSession(jparams, jcfg, TARGETS, phoneme_list=PHONEMES)
    sess = _session(tree, phoneme_list=PHONEMES)
    ttrie, jtrie = tctc.LexiconTrie(LEXICON), jctc.LexiconTrie(LEXICON)
    assert sess.partial()["num_steps"] == 0
    for start in range(0, 96, 32):
        jsess.push(raw[start: start + 32])
        sess.push(raw[start: start + 32])
        got, want = sess.partial(), jsess.partial()
        assert got["phonemes"] == want["phonemes"] and got["num_steps"] == want["num_steps"]
        got = sess.partial(lexicon=ttrie)
        assert got["words"] == jsess.partial(lexicon=jtrie)["words"]
    assert got["num_steps"] == 24
    # the carried beam equals the from-scratch search over the history
    logp = np.concatenate(sess._ctc_logps, axis=0)[: sess._enc_steps]
    assert got["words"][0] == tctc.ctc_word_beam_search(logp[:, 0], ttrie, beam_width=8)
    assert sess.partial(lexicon=ttrie)["words"] == got["words"]  # nothing new
    # the endpoint's greedy partial equals the offline CTC decode
    params = convert.params_from_numpy(tree, device="cpu")
    with torch.inference_mode():
        enc, _, lens = ts.encode(params, _port_cfg(), torch.from_numpy(raw)[None],
                                 torch.tensor([96]), 0)
        path, _ = tserve._ctc_head_apply(params, _port_cfg(), "ph", enc.transpose(0, 1), False)
    offline = [PHONEMES[i] for i in tctc.collapse_alignment(path[:, 0]) if i != 9]
    assert sess.partial()["phonemes"][0] == offline
    assert isinstance(sess.endpoint()["sequences"][0], str)


def test_pool_matches_jax_sessions_and_offline(model):
    """Streams with their own start times, ragged pushes, a mid-stream
    decode and a join into a released slot: each stream's pooled result
    equals the JAX pool's, a dedicated session's and the offline decode."""
    jcfg, jparams, tree = model
    raws = {"a": _raw(1, 147), "b": _raw(2, 83), "c": _raw(3, 64)}
    jpool = jserve.StreamingSessionPool(jparams, jcfg, TARGETS, capacity=4)
    pool = _pool(tree, capacity=4)
    sessions = {k: _session(tree) for k in raws}
    slots = {}
    fed = dict.fromkeys(raws, 0)

    def join(k):
        slots[k] = (pool.add(), jpool.add())
        assert slots[k][0] == slots[k][1]

    def feed(k, n):
        chunk = raws[k][fed[k]: fed[k] + n]
        if len(chunk):
            pool.push(slots[k][0], chunk)
            jpool.push(slots[k][1], chunk)
            sessions[k].push(chunk)
            fed[k] += len(chunk)

    def check(got, want, sess):
        np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["tokens"], sess["tokens"])
        np.testing.assert_allclose(got["encoder_outputs"], sess["encoder_outputs"], **F32)
        np.testing.assert_allclose(got["encoder_outputs"],
                                   np.asarray(want["encoder_outputs"]), **F32)

    join("a")
    feed("a", 37)
    feed("a", 37)
    join("b")
    for k, n in (("b", 29), ("a", 37), ("b", 29)):
        feed(k, n)
    check(pool.decode(slots["b"][0]), jpool.decode(slots["b"][1]), sessions["b"].decode())
    for k, n in (("b", 29), ("a", 37), ("a", 37)):
        feed(k, n)
    got = pool.endpoint(slots["a"][0])
    check(got, jpool.endpoint(slots["a"][1]), sessions["a"].endpoint())
    np.testing.assert_array_equal(got["tokens"], _offline(tree, raws["a"]))
    join("c")
    assert slots["c"][0] == slots["a"][0]  # the released slot is reused
    feed("c", 64)
    feed("b", 100)
    for k in ("c", "b"):
        got = pool.endpoint(slots[k][0])
        check(got, jpool.endpoint(slots[k][1]), sessions[k].endpoint())
        np.testing.assert_array_equal(got["tokens"], _offline(tree, raws[k]))
    with pytest.raises(ValueError, match="not active"):
        pool.push(slots["b"][0], raws["b"][:8])


def test_pool_random_joins_and_leaves_match_sessions(model):
    _, _, tree = model
    rng = np.random.default_rng(1)
    pool = _pool(tree, capacity=3, max_pending_chunks=2)
    live: dict = {}
    finished = 0

    def finish(slot):
        samples = np.concatenate(live.pop(slot) or [np.zeros((0, 8), np.float32)])
        got = pool.endpoint(slot)
        sess = _session(tree)
        if len(samples):
            sess.push(samples)
        want = sess.endpoint()
        if got["tokens"] is None:
            assert want["tokens"] is None
        else:
            np.testing.assert_array_equal(got["tokens"], want["tokens"])

    for _ in range(40):
        roll = rng.random()
        if (roll < 0.25 and len(live) < 3) or not live:
            live[pool.add()] = []
        elif roll < 0.85:
            slot = int(rng.choice(list(live)))
            pkt = rng.normal(size=(int(rng.integers(1, 40)), 8)).astype(np.float32)
            live[slot].append(pkt)
            pool.push(slot, pkt)
        else:
            finish(int(rng.choice(list(live))))
            finished += 1
    for slot in list(live):
        finish(slot)
        finished += 1
    assert finished >= 5


def test_pool_partial_matches_session_partial(model):
    _, _, tree = model
    raw = _raw(4, 90)
    pool = _pool(tree, capacity=2, phoneme_list=PHONEMES)
    sess = _session(tree, phoneme_list=PHONEMES)
    trie = tctc.LexiconTrie(LEXICON)
    other = pool.add()
    slot = pool.add()
    for start in range(0, 90, 23):
        pool.push(slot, raw[start: start + 23])
        pool.push(other, raw[::-1][start: start + 23])
        sess.push(raw[start: start + 23])
        got, want = pool.partial(slot, lexicon=trie), sess.partial(lexicon=trie)
        assert got["phonemes"] == want["phonemes"][0]
        assert got["words"] == want["words"][0]
        assert got["num_steps"] == want["num_steps"]


def test_int8_host_upload_contract(model):
    """Each block is quantized on the host (per-row-per-channel scales) and
    dequantized on the device: the session and the pool equal the JAX
    package's, and the offline decode of the same dequantized inputs."""
    jcfg, jparams, tree = model
    raw = _raw(7, 147)
    sess = _session(tree, host_upload="int8")
    pool = _pool(tree, capacity=2, host_upload="int8")
    jsess = jserve.StreamingConformerSession(jparams, jcfg, TARGETS, host_upload="int8")
    slot = pool.add()
    for lo in range(0, 147, 29):
        for s in (sess, jsess):
            s.push(raw[lo: lo + 29])
        pool.push(slot, raw[lo: lo + 29])
    spc = sess.samples_per_chunk
    dq = np.zeros((148, 8), np.float32)
    for lo in range(0, 147, spc):
        block = np.zeros((1, spc, 8), np.float32)
        n = min(spc, 147 - lo)
        block[0, :n] = raw[lo: lo + n]
        q, scales = tserve._quantize_host_block(block)
        jq, jscales = jserve._quantize_host_block(block)
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(scales, jscales)
        deq = q.astype(np.float32) * scales[:, None, :]
        assert (np.abs(deq - block) < np.abs(block).max(axis=1, keepdims=True) / 252 + 1e-7).all()
        dq[lo: lo + n] = deq[0, :n]
    off = _offline(tree, dq[:147])
    got_s, got_p, want = sess.endpoint(), pool.endpoint(slot), jsess.endpoint()
    for got in (got_s, got_p):
        np.testing.assert_array_equal(got["tokens"], off)
        np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got_p["encoder_outputs"], got_s["encoder_outputs"], **F32)
    for make in (_session, lambda t, **kw: _pool(t, capacity=2, **kw)):
        with pytest.raises(ValueError, match="host_upload"):
            make(tree, host_upload="fp8")


@pytest.mark.parametrize("impl", ["dense", "banded"])
def test_per_row_offsets_equal_rows_encoded_alone(impl):
    """``conformer_encode`` with a (B,) tensor of offsets and per-row
    lengths equals each row encoded alone with its int offset (what the
    JAX pool gets by ``vmap``); the kernels' impls refuse per-row offsets."""
    cfg = tc.ConformerConfig(**CONFORMER, attention_impl=impl, query_block_chunks=2)
    params = tc.init_conformer(torch.Generator().manual_seed(0), cfg, 12, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 24, 12)).astype(np.float32))
    offsets = torch.tensor([-16, 8, 40])
    lengths = torch.tensor([5, 30, 64], dtype=torch.int32)
    with torch.inference_mode():
        got, _ = tc.conformer_encode(params, cfg, x, lengths, position_offset=offsets,
                                     mask_invalid=True)
        for b in range(3):
            want, _ = tc.conformer_encode(params, cfg, x[b: b + 1], lengths[b: b + 1],
                                          position_offset=int(offsets[b]), mask_invalid=True)
            np.testing.assert_allclose(got[b: b + 1].numpy(), want.numpy(), **F32)
    for kernel_impl in ("flash", "fused"):
        with pytest.raises(ValueError, match="per-row"):
            tc.conformer_encode(params, tc.ConformerConfig(**CONFORMER, attention_impl=kernel_impl),
                                x, lengths, position_offset=offsets)


@pytest.mark.parametrize("use_pallas", [True, "bi_grid"])
def test_export_round_trip_on_the_cpu(tmp_path, use_pallas):
    kw = dict(vocab_size=20, in_channels=5, conv_sizes=(6,), decimation_factor=3,
              rnn_sizes=(8, 8), dec_embedding_size=6, dec_rnn_sizes=(12,), max_dec_len=6)
    jcfg = js.Seq2SeqConfig(**kw)
    tree = jax.tree.map(np.asarray, js.init_seq2seq(jax.random.PRNGKey(0), jcfg))
    cfg = ts.Seq2SeqConfig(**kw, use_pallas_lstm=use_pallas)
    targets = ["<pad>", "<EOS>", "<OOV>"] + [f"w{i}_" for i in range(3, 20)]
    live = tserve.OnlinePredictor(convert.params_from_numpy(tree, "cpu"), cfg, targets,
                                  max_samples=36, device="cpu")
    path = tserve.export_predictor(live, str(tmp_path / "artifact"))
    loaded = tserve.load_exported_predictor(path)
    assert loaded.meta["format"] == "ecog2txt_tpu_torch.exported_predictor/1"
    assert set(loaded.meta) >= {"format", "targets_list", "max_samples", "in_channels",
                                "platforms", "jax_version", "outputs"}
    op = "lstm_recurrence" if use_pallas is True else "bilstm_grid_fwd"
    calls = [n for n in loaded.program.graph.nodes if f"ecog2txt_tpu_torch.{op}" in str(n.target)]
    assert len(calls) == (4 if use_pallas is True else 2) * 2  # greedy + teacher-forced encodes
    rng = np.random.default_rng(0)
    jpred = jserve.OnlinePredictor(js.init_seq2seq(jax.random.PRNGKey(0), jcfg), jcfg, targets,
                                   max_samples=36)
    jloaded = jserve.load_exported_predictor(
        jserve.export_predictor(jpred, str(tmp_path / "jax"), platforms=("cpu",)))
    for x in (rng.normal(size=(3, 33, 5)), rng.normal(size=(30, 4)), rng.normal(size=(50, 5))):
        x = x.astype(np.float32)
        got, want = loaded(x), live(x)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["probabilities"], want["probabilities"])
        np.testing.assert_array_equal(got["tokens"], jpred(x)["tokens"])
        np.testing.assert_array_equal(got["tokens"], np.asarray(jloaded(x)["tokens"]))
        assert got["sequences"] == want["sequences"]
    with pytest.raises(ValueError, match="channels"):
        loaded(np.zeros((20, 6), np.float32))


# JAX's tests/test_export.py configurations
EXPORT_KW = dict(vocab_size=12, num_subjects=1, in_channels=8, conv_sizes=(16,),
                 decimation_factor=4, rnn_sizes=(24,), aux_proj_sizes=(), aux_heads=(),
                 dec_embedding_size=12, dec_rnn_sizes=(48,), max_dec_len=6)
EXPORT_MOE = {"conformer": {}, "moe": dict(moe_experts=4),
              "moe_capacity": dict(moe_experts=4, moe_capacity_factor=1.25, moe_group_size=8)}


@pytest.mark.parametrize("family,impl", [("conformer", "flash"), ("moe", "fused"),
                                         ("moe_capacity", "flash")])
def test_export_conformer_families_match_jax(tmp_path, family, impl):
    """The conformer families of JAX's ``test_export_roundtrip_exact`` (the
    biLSTM's is ``test_export_round_trip_on_the_cpu``), with the same
    weights: the port's program (batch symbolic, 1 to 4096) gives
    the live predictor's tokens and JAX's exported program's at B=1, 3 and
    256, where B·T' = 4096 reaches the depthwise conv's eager crossover, and
    its probabilities at the f32 tolerance (below the crossover the live
    predictor sums the conv in another order).  Its conformer program calls
    the K2f / K3f operator once a block and encode."""
    conformer = dict(CONFORMER, **EXPORT_MOE[family])
    jcfg = js.Seq2SeqConfig(**EXPORT_KW, encoder_type="conformer",
                            conformer=JConformer(**conformer))
    cfg = ts.Seq2SeqConfig(**EXPORT_KW, encoder_type="conformer",
                           conformer=tc.ConformerConfig(**conformer, attention_impl=impl))
    jparams = js.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    live = tserve.OnlinePredictor(convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                            "cpu"),
                                  cfg, TARGETS, max_samples=64, device="cpu")
    loaded = tserve.load_exported_predictor(tserve.export_predictor(live, str(tmp_path / "t")))
    jloaded = jserve.load_exported_predictor(jserve.export_predictor(
        jserve.OnlinePredictor(jparams, jcfg, TARGETS, max_samples=64), str(tmp_path / "j"),
        platforms=("cpu",)))
    op = {"flash": "banded_attention_fwd", "fused": "fused_attention_fwd"}[impl]
    calls = [n for n in loaded.program.graph.nodes if f"ecog2txt_tpu_torch.{op}" in str(n.target)]
    assert len(calls) == 2 * CONFORMER["num_blocks"]  # greedy + teacher-forced encodes
    rng = np.random.default_rng(7)
    for B in (1, 3, 256):
        x = rng.normal(size=(B, 50, 8)).astype(np.float32)
        got, want = loaded(x), live(x)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["probabilities"], want["probabilities"], **F32)
        np.testing.assert_array_equal(got["tokens"], np.asarray(jloaded(x)["tokens"]))
        assert got["sequences"] == want["sequences"]


def test_from_trainer_with_a_ctc_head(tmp_path):
    sizes = {"encoder_embedding": [16], "encoder_rnn": [24], "encoder_1_projection": [16],
             "decoder_embedding": [12], "decoder_rnn": [48], "decoder_projection": []}
    mp = tdemo.make_demo_experiment(str(tmp_path / "exp"), subject_ids=(1,), layer_sizes=sizes,
                                    phoneme_sequence_distribution="CTC")
    tr = ttrain.MultiSubjectTrainer(
        mp, [1], VERBOSE=False, device="cpu",
        SN_kwargs={"batch_size": 16, "max_dec_len": 6, "encoder_type": "conformer",
                   "conformer": dict(CONFORMER, attention_impl="flash")},
    )
    phonemes = tr.target_subject.data_manifests["encoder_1_targets"].feature_list
    val = tr.packed_dataset("validation")
    x = val.encoder_inputs[0, 0, : int(val.encoder_lengths[0, 0])]
    sess = tserve.StreamingConformerSession.from_trainer(tr)
    pool = tserve.StreamingSessionPool.from_trainer(tr, capacity=2)
    assert sess.phoneme_list == pool.phoneme_list == list(phonemes)
    assert sess.device.type == pool.device.type == "cpu"
    slot = pool.add()
    sess.push(x)
    pool.push(slot, x)
    assert sess.partial()["phonemes"][0] == pool.partial(slot)["phonemes"]
    assert all(p in phonemes for p in sess.partial()["phonemes"][0])
    got, want = pool.endpoint(slot), sess.endpoint()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_unported_serving_options_name_the_roadmap(model):
    """``quantize='int8'`` and ``RawVoltageSession`` are ported (held to JAX
    in ``tests/test_torch_quantize.py`` and below); what stays refused is
    refused with a ``ValueError``."""
    _, _, tree = model
    assert tquantize.is_quantized(_session(tree, quantize="int8").params)
    assert tquantize.is_quantized(_pool(tree, quantize="int8").params)
    with pytest.raises(ValueError, match="quantize"):
        _session(tree, quantize="int4")
    raw = tserve.RawVoltageSession(_session(tree), HG)
    assert raw.frontend.device == raw.session.device
    with pytest.raises(ValueError, match="zscore='none'"):
        tserve.RawVoltageSession(_session(tree), tfeatures.HighGammaConfig(1000.0, 200.0))
    with pytest.raises(ValueError, match="encoder_type"):
        tserve.StreamingConformerSession(
            convert.params_from_numpy(tree, "cpu"), ts.Seq2SeqConfig(vocab_size=12), TARGETS,
            device="cpu",
        )


def _raw_session_case(model, seed):
    """Calibration statistics, a raw recording whose length is no multiple
    of the window, the decimation or a chunk, and the offline tokens of its
    calibrated offline features."""
    _, _, tree = model
    rng = np.random.default_rng(seed)
    stats = tfeatures.calibrate_high_gamma([rng.normal(size=(4000, 8)).astype(np.float32)], HG,
                                           device="cpu")
    raw = rng.normal(size=(1510, 8)).astype(np.float32)
    feats = (tfeatures.extract_high_gamma_np(raw, HG, device="cpu") - stats[0]) / np.maximum(
        stats[1], 1e-6)
    return tree, stats, raw, _offline(tree, feats)


@pytest.mark.parametrize("int16", [False, True])
def test_raw_voltage_session_matches_offline_and_jax(model, int16):
    """Ragged pushes with ``decode()`` after each (repeatable, and the
    stream goes on unchanged); the endpoint equals the offline decode of
    ``(extract_high_gamma_np(raw) - mean) / std`` and JAX's raw session.
    int16 samples (``input_scale`` volts a unit) equal the float session
    on the scaled samples."""
    jcfg, jparams, _ = model
    tree, stats, raw, offline = _raw_session_case(model, 5)
    hg = HG
    if int16:
        hg = tfeatures.HighGammaConfig(**{**HG.__dict__, "input_scale": 1e-3})
        raw_in = np.clip(raw * 1000, -32768, 32767).astype(np.int16)
        raw = raw_in.astype(np.float32) * np.float32(1e-3)
        feats = (tfeatures.extract_high_gamma_np(raw, HG, device="cpu") - stats[0]) / np.maximum(
            stats[1], 1e-6)
        offline = _offline(tree, feats)
    else:
        raw_in = raw
    session = tserve.RawVoltageSession(_session(tree), hg, stats=stats, window_seconds=0.5)
    jsession = jserve.RawVoltageSession(jserve.StreamingConformerSession(jparams, jcfg, TARGETS),
                                        jfeatures.HighGammaConfig(**hg.__dict__), stats=stats,
                                        window_seconds=0.5)
    pos = 0
    for step in (333, 41, 700, 129, 307):
        session.push(raw_in[pos: pos + step])
        jsession.push(raw_in[pos: pos + step])
        pos += step
        a, b = session.decode(), session.decode()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"], np.asarray(jsession.decode()["tokens"]))
    out = session.endpoint()
    np.testing.assert_array_equal(out["tokens"], offline)
    np.testing.assert_array_equal(out["tokens"], np.asarray(jsession.endpoint()["tokens"]))
    assert np.isfinite(out["encoder_outputs"]).all()
