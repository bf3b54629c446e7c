"""The port's host-sharded and lazy data path held to the JAX package.

``pipeline.LazyShardedDataset`` (shards re-read from the records) and
``pipeline.shard_dataset`` (slices of a packed partition) give the JAX
package's shards exactly, with and without a restricted trial subset, on
a two-subject demo experiment with heterogeneous channels (records
byte-identical between the packages); ``prefetch`` keeps the producer's
order; and a port ``fit`` under ``max_host_trials`` follows the same
trajectory as under ``max_device_trials`` at the same shard size, as
JAX's ``test_trainer_max_host_trials_same_trajectory``.
"""

import threading

import numpy as np
import pytest
import torch

from ecog2txt_tpu import pipeline as jpipeline
from ecog2txt_tpu.demo import make_demo_experiment as jmake_demo
from ecog2txt_tpu.train import MultiSubjectTrainer as JTrainer
from ecog2txt_tpu_torch import pipeline as tpipeline
from ecog2txt_tpu_torch.convert import tree_leaves
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.train import MultiSubjectTrainer
from torch_threads import one_torch_thread  # noqa: F401

TINY = {
    "encoder_embedding": [16],
    "encoder_rnn": [24],
    "encoder_1_projection": [16],
    "decoder_embedding": [12],
    "decoder_rnn": [32],
    "decoder_projection": [],
}
GRIDS = {1: (4, 4), 2: (3, 4)}


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy")
    tr = MultiSubjectTrainer(
        make_demo_experiment(str(root / "t"), subject_ids=(1, 2), grid_sizes=GRIDS,
                             layer_sizes=TINY),
        [1, 2], VERBOSE=False, device="cpu")
    jtr = JTrainer(jmake_demo(str(root / "j"), subject_ids=(1, 2), grid_sizes=GRIDS,
                              layer_sizes=TINY), [1, 2], VERBOSE=False)
    tr.write_tf_records_maybe()
    jtr.write_tf_records_maybe()
    return tr, jtr


def _assert_shards_equal(got, want, references=True):
    """Every array equal; the reference strings too, where both shards are
    of one kind (a lazy shard pads them with empty lists, a slice of a
    packed partition does not)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gb, wb = g.batch_dict(), w.batch_dict()
        assert sorted(gb) == sorted(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        np.testing.assert_array_equal(g.trial_mask, w.trial_mask)
        if references:
            assert g.references == w.references


def _kw(tr):
    return dict(pad_channels_to=tr.net_config.in_channels,
                pad_time_multiple=tr.net_config.decimation_factor)


@pytest.mark.parametrize("subset", [None, [1, 4, 7, 2, 9, 11, 13, 0]])
def test_shards_equal_jax(trainers, subset):
    """Lazy shards and eager slices, both packages: all four equal shard
    for shard (the eager ones of a restricted partition keep its full-N
    tail, which holds no trial); re-iterating reads the same shards."""
    tr, jtr = trainers
    trial_subset = None if subset is None else {0: subset}
    tfull = tpipeline.pack_partition(tr.ecog_subjects, "training", **_kw(tr))
    jfull = jpipeline.pack_partition(jtr.ecog_subjects, "training", **_kw(jtr))
    if subset is not None:
        tfull = tpipeline.restrict_trials(tfull, 0, subset)
        jfull = jpipeline.restrict_trials(jfull, 0, subset)
    teager = tpipeline.shard_dataset(tfull, 6)
    jeager = jpipeline.shard_dataset(jfull, 6)
    _assert_shards_equal(teager, jeager)
    tlazy = tpipeline.LazyShardedDataset(tr.ecog_subjects, "training", 6,
                                         trial_subset=trial_subset, **_kw(tr))
    jlazy = jpipeline.LazyShardedDataset(jtr.ecog_subjects, "training", 6,
                                         trial_subset=trial_subset, **_kw(jtr))
    np.testing.assert_array_equal(tlazy.num_trials, jlazy.num_trials)
    np.testing.assert_array_equal(tlazy.trial_lengths(0), jlazy.trial_lengths(0))
    got = list(tlazy)
    _assert_shards_equal(got, list(jlazy))
    _assert_shards_equal(got, teager[: len(got)], references=False)
    assert all(int(s.num_trials.sum()) == 0 for s in teager[len(got):])
    _assert_shards_equal([next(iter(tlazy))], got[:1])
    tlazy.close()
    jlazy.close()


def test_prefetch_keeps_the_order_and_overlaps():
    """One item ahead in one worker thread: items come in the producer's
    order, and the next is made while the consumer holds the current."""
    made, seen = [], []
    gate = threading.Event()
    it = iter(range(4))

    def produce():
        i = next(it, None)
        if i is None:
            return tpipeline._PREFETCH_END
        made.append(i)
        if i == 1:
            gate.set()
        return i

    for item in tpipeline.prefetch(produce):
        if item == 0:
            assert gate.wait(timeout=10)  # item 1 was made while 0 is held
        seen.append(item)
    assert seen == made == [0, 1, 2, 3]
    it = iter(range(3))
    assert list(tpipeline.prefetch(produce, depth=0)) == [0, 1, 2]


def test_max_host_trials_same_trajectory(tmp_path):
    """Training under a forced host budget (``max_host_trials``) follows
    the same trajectory as the resident corpus streamed in shards of the
    same size (``max_device_trials``): the same WERs and, on the CPU, the
    same parameters bit for bit; the shards' generators fold the shard
    index into the segment's seed, so the dropout masks match too."""
    def run(extra):
        mp = make_demo_experiment(str(tmp_path / sorted(extra)[0]), subject_ids=(1,),
                                  layer_sizes=TINY, assessment_epoch_interval=3)
        tr = MultiSubjectTrainer(
            mp, [1], VERBOSE=False, device="cpu",
            SN_kwargs={"batch_size": 8, "max_dec_len": 10, "learning_rate": 3e-3,
                       "use_pallas_lstm": True, **extra})
        history = tr.fit(num_epochs=6)
        return [h["training"]["word_error_rate"] for h in history.values()], tr

    wers_host, host = run({"max_host_trials": 16})
    wers_dev, dev = run({"max_device_trials": 16})
    assert wers_host == wers_dev and len(wers_host) == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(host.state.params),
                                                 tree_leaves(dev.state.params)))
    assert host.state.epoch == dev.state.epoch == 6
