"""The port's transfer learning held to the JAX package at small sizes.

Scope masks (``_scope_mask``) leaf for leaf against JAX's; one segment of
the segment runner under each mask and under each warmup schedule, at
dropout 0, against JAX's ``make_segment_runner`` with the optimizer of
JAX's ``_make_optimizer`` (params, EMA and the per-step learning rate; a
frozen core stays bit-identical); ``lr_schedule`` against optax's
schedules step by step; the curriculum of ``sequential_transfer_learn``
call for call against JAX's; and the port's trainer on a two-subject demo
experiment (donor 3x4, target 4x4 channels): RESUME leaves the donor row
as it was, and a tiny curriculum counts its epochs and freezes its core.
Parameters come from JAX's ``init_seq2seq`` (``params_from_numpy``),
inputs from a numpy seed.  Tolerances: f32 rtol 1e-4 / atol 1e-5; after
several Adam steps params and EMA atol 1e-4, as
``test_segment_runner_matches_jax`` states why.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.demo import make_demo_experiment as jmake_demo
from ecog2txt_tpu.models import seq2seq as js
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import params_from_numpy, tree_leaves, tree_map
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.models import seq2seq as ts
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
ADAM = dict(rtol=1e-4, atol=1e-4)
TINY = {
    "encoder_embedding": [16],
    "encoder_rnn": [24],
    "encoder_1_projection": [16],
    "decoder_embedding": [12],
    "decoder_rnn": [48],
    "decoder_projection": [],
}
GRIDS = {1: (3, 4), 2: (4, 4)}
SN = {"batch_size": 16, "max_dec_len": 10, "learning_rate": 3e-3}
SCOPES = (r"seq2seq/subnet", r"seq2seq/(?!subnet)")

B, T, C, L = 3, 24, 5, 5


def _flat_by_path(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts and lists (either package)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_by_path(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_by_path(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _configs():
    kw = dict(vocab_size=20, in_channels=C, conv_sizes=(6,), decimation_factor=3,
              rnn_sizes=(8,), aux_proj_sizes=(7,), dec_embedding_size=6,
              dec_rnn_sizes=(12,), max_dec_len=L, num_subjects=2, FF_dropout=0.0,
              RNN_dropout=0.0)
    jcfg = js.Seq2SeqConfig(**kw, aux_heads=(js.AuxHead("aux", "categorical", 4),))
    tcfg = ts.Seq2SeqConfig(**kw, aux_heads=(ts.AuxHead("aux", "categorical", 4),),
                            use_pallas_lstm=True)
    return jcfg, tcfg


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, L + 1, size=n).astype(np.int32)
    dec = rng.integers(3, 20, size=(n, L)).astype(np.int32)
    pos = np.arange(L)
    dec = np.where(pos == lens[:, None] - 1, 1, dec)
    dec = np.where(pos >= lens[:, None], 0, dec).astype(np.int32)
    return {
        "encoder_inputs": rng.normal(size=(n, T, C)).astype(np.float32),
        "encoder_lengths": rng.integers(6, T + 1, size=n).astype(np.int32),
        "decoder_targets": dec,
        "decoder_lengths": lens,
        "aux": rng.integers(0, 4, size=(n, T)).astype(np.int32),
    }


def _fake_trainers(jparams, tparams, sn):
    """The JAX and port trainers' optimizer methods over given parameters,
    without building a trainer (``_scope_mask`` reads only the state's
    parameter tree; the schedule only SN_kwargs and the rate)."""
    lr = sn.get("learning_rate", 1e-2)
    jfake = types.SimpleNamespace(SN_kwargs=sn, learning_rate=lr,
                                  state=types.SimpleNamespace(params=jparams))
    jfake._scope_mask = functools.partial(jtrain.MultiSubjectTrainer._scope_mask, jfake)
    tfake = types.SimpleNamespace(SN_kwargs=sn, learning_rate=lr,
                                  state=types.SimpleNamespace(params=tparams))
    return jfake, tfake


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, _ = _configs()
    return js.init_seq2seq(jax.random.PRNGKey(0), jcfg)


@pytest.mark.parametrize("scope", SCOPES)
def test_scope_mask_matches_jax(scope):
    jp = _params()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jfake, tfake = _fake_trainers(jp, tp, {})
    want = _flat_by_path(jtrain.MultiSubjectTrainer._scope_mask(jfake, scope))
    got = _flat_by_path(ttrain.MultiSubjectTrainer._scope_mask(tfake, scope))
    assert got == want and len(got) == len(tree_leaves(tp))
    assert {p.split("/")[1] for p, v in got.items() if v} == (
        {"subnet"} if scope == SCOPES[0] else {"encoder", "aux", "decoder"})
    assert ttrain.MultiSubjectTrainer._scope_mask(tfake, None) is None


# each mask, each schedule and neither (a JAX runner compiles per case)
CASES = [
    (None, {}),
    (SCOPES[1], {}),
    (None, {"warmup_steps": 2}),
    (SCOPES[0], {"warmup_steps": 3, "lr_schedule": "warmup_cosine"}),
]


@pytest.mark.parametrize("scope,sn", CASES)
def test_masked_scheduled_segment_matches_jax(scope, sn):
    """A 4-step segment over two subjects from the same params and
    schedule at dropout 0, the optimizers from each trainer's own
    ``_make_optimizer`` / ``_scope_mask`` + ``_lr_schedule`` over 5 total
    steps (so the cosine has decayed part way): loss, params and EMA agree;
    the rates the port took are optax's at counts 0-3; the leaves outside
    the scope are bit-identical to where they started, in both packages."""
    jcfg, tcfg = _configs()
    scales = {"aux": 1.0, "decoder_targets": 1.0}
    sn = {"learning_rate": 1e-2, **sn}
    decay, total = 0.9, 5
    jp = _params()
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, "cpu")
    data = {k: np.stack([v, _batch(9, 6)[k]]) for k, v in _batch(8, 6).items()}
    subjects = np.array([0, 1, 1, 0], np.int32)
    idx = np.array([[0, 3, 5], [1, 2, 4], [5, 5, 0], [2, 1, 4]], np.int32)
    jfake, tfake = _fake_trainers(jp, tp, sn)

    optimizer = jtrain.MultiSubjectTrainer._make_optimizer(jfake, scope, total_steps=total)
    jstate = jtrain.TrainState(jp, jax.tree.map(jnp.copy, jp), optimizer.init(jp),
                               jnp.asarray(0, jnp.int32))
    jrun = jtrain.make_segment_runner(jcfg, optimizer, scales, decay)
    jstate, jmetrics = jrun(jstate, {k: jnp.asarray(v) for k, v in data.items()},
                            subjects, idx, jax.random.PRNGKey(0), 1)

    schedule = ttrain.MultiSubjectTrainer._lr_schedule(tfake, total)
    mask = ttrain.MultiSubjectTrainer._scope_mask(tfake, scope)
    opt = ttrain.make_optimizer(tp, sn["learning_rate"], schedule, mask)
    tstate = ttrain.TrainState(tp, tree_map(lambda t: t.detach().clone(), tp), opt, 0)
    trun = ttrain.make_segment_runner(tcfg, scales, decay)
    tstate, tmetrics = trun(tstate, {k: torch.from_numpy(v) for k, v in data.items()},
                            subjects, idx, torch.Generator().manual_seed(0), 1)

    np.testing.assert_allclose(float(tmetrics["loss_total"]),
                               float(jmetrics["loss_total"]), **F32)
    if "warmup_steps" in sn:
        kind = sn.get("lr_schedule")
        w = sn["warmup_steps"]
        want = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, w, max(total, w + 1))
                if kind == "warmup_cosine" else optax.linear_schedule(0.0, 1e-2, w))
        np.testing.assert_allclose(opt.learning_rates, [float(want(c)) for c in range(4)],
                                   rtol=1e-6, atol=1e-12)
        assert opt.learning_rates[0] == 0.0
    else:
        assert opt.learning_rates == [1e-2] * 4
    got_p, got_e = _flat_by_path(tstate.params), _flat_by_path(tstate.ema)
    want_p = _flat_by_path(jax.tree.map(np.asarray, jstate.params))
    want_e = _flat_by_path(jax.tree.map(np.asarray, jstate.ema))
    start = _flat_by_path(tree)
    trainable = _flat_by_path(mask) if mask is not None else {p: True for p in start}
    for path in want_p:
        np.testing.assert_allclose(got_p[path].detach().numpy(), want_p[path],
                                   err_msg=path, **ADAM)
        np.testing.assert_allclose(got_e[path].numpy(), want_e[path], err_msg=path, **ADAM)
        if not trainable[path]:
            np.testing.assert_array_equal(got_p[path].detach().numpy(), start[path],
                                          err_msg=path)
            np.testing.assert_array_equal(want_p[path], start[path], err_msg=path)


@pytest.mark.parametrize("kind", [None, "warmup_cosine"])
@pytest.mark.parametrize("warmup,total", [(1, 1), (3, 10), (4, 4), (5, 64)])
def test_lr_schedule_is_optax(kind, warmup, total):
    """Count by count from 0 past the end.  optax evaluates in float32 (its
    cosine too), the port in float64: float32 rounding of terms of size
    ``lr`` gives rtol 1e-5 and, where the cosine nears 0, atol 1e-6 lr."""
    lr = 3e-3
    schedule = ttrain.lr_schedule(lr, warmup, total, kind)
    want = (optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
            if kind == "warmup_cosine" else optax.linear_schedule(0.0, lr, warmup))
    for count in range(total + 4):
        np.testing.assert_allclose(schedule(count), float(want(count)), rtol=1e-5,
                                   atol=1e-6 * lr, err_msg=str(count))
    assert ttrain.lr_schedule(lr, 0, total, kind) is None
    assert ttrain.lr_schedule(lr, warmup, None, kind) is None


def test_sequential_curriculum_matches_jax(tmp_path):
    """``sequential_transfer_learn`` makes the same ``fit`` calls in the
    same order in both packages (recorded, not run), and ends on the same
    epoch count: donor training, then for the target a frozen-core subnet
    fit on its own batches, unassessed, and training + posttraining on
    both."""
    def record(trainer, calls):
        def fit(subject_subset=None, num_epochs=None, train_vars_scope=None, assess=True, **kw):
            calls.append((list(subject_subset), num_epochs, train_vars_scope, assess))
            trainer.state = trainer.state._replace(epoch=trainer.state.epoch + num_epochs)
            return {}
        trainer.fit = fit
        trainer.save_checkpoint = lambda *a, **k: None
        return trainer

    jmp = jmake_demo(str(tmp_path / "j"), subject_ids=(1, 2), layer_sizes=TINY, grid_sizes=GRIDS)
    tmp = make_demo_experiment(str(tmp_path / "t"), subject_ids=(1, 2), layer_sizes=TINY,
                               grid_sizes=GRIDS)
    jcalls, tcalls = [], []
    jtr = record(jtrain.MultiSubjectTrainer(jmp, [1, 2], SN_kwargs=SN, VERBOSE=False), jcalls)
    ttr = record(ttrain.MultiSubjectTrainer(tmp, [1, 2], SN_kwargs=SN, VERBOSE=False,
                                            device="cpu"), tcalls)
    jtr.sequential_transfer_learn(pretraining=4, training=6, posttraining=3)
    ttr.sequential_transfer_learn(pretraining=4, training=6, posttraining=3)
    assert tcalls == jcalls == [([0], 6, None, True), ([1], 4, SCOPES[0], False),
                                ([0, 1], 9, None, True)]
    assert int(ttr.state.epoch) == int(jtr.state.epoch) == 6 + 4 + 9


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    mp = make_demo_experiment(
        str(tmp_path_factory.mktemp("xfer") / "exp"), subject_ids=(1, 2), layer_sizes=TINY,
        grid_sizes=GRIDS, assessment_epoch_interval=2,
    )
    return ttrain.MultiSubjectTrainer(
        mp, [1, 2], SN_kwargs={**SN, "use_pallas_lstm": True, "warmup_steps": 2,
                               "lr_schedule": "warmup_cosine"},
        VERBOSE=False, device="cpu",
    )


def test_sequential_transfer_learn_counts_epochs_and_freezes_the_core(trainer):
    """A tiny curriculum (pretraining=1, training=2, posttraining=1) on the
    CPU: 2 + 1 + 3 epochs; in the frozen fit every encoder, aux and
    decoder leaf is bit-identical before and after, the donor's subnet row
    too, and the target's row moves; the optimizer restarts with its
    schedule at every fit."""
    fits = []
    fit = trainer.fit

    def spy(**kw):
        before = [t.detach().clone() for t in tree_leaves(trainer.state.params)]
        history = fit(**kw)
        fits.append((kw, before, [t.detach().clone() for t in
                                  tree_leaves(trainer.state.params)],
                     list(trainer.state.opt_state.learning_rates)))
        return history

    trainer.fit = spy
    try:
        history = trainer.sequential_transfer_learn(pretraining=1, training=2, posttraining=1)
    finally:
        del trainer.fit
    assert int(trainer.state.epoch) == 2 + 1 + 3
    assert list(history) == ["5", "6"]
    assert [kw.get("train_vars_scope") for kw, *_ in fits] == [None, SCOPES[0], None]
    kw, before, after, rates = fits[1]
    names = list(_flat_by_path(trainer.state.params))
    for name, b, a in zip(names, before, after):
        if name.startswith("/subnet"):
            assert torch.equal(a[0], b[0]), name  # the donor's row
            assert not torch.equal(a[1], b[1]), name  # the target's row
        else:
            assert torch.equal(a, b), name
    for _, _, _, rates in fits:
        assert rates[0] == 0.0 and max(rates) == pytest.approx(3e-3)


def test_resume_leaves_the_donor_row(trainer):
    before = trainer.state.params["subnet"]["conv"][0]["w"].detach().clone()
    trainer.parallel_transfer_learn(RESUME=True, num_epochs=2, assess=False)
    after = trainer.state.params["subnet"]["conv"][0]["w"]
    assert torch.equal(after[0], before[0])
    assert not torch.equal(after[1], before[1])
