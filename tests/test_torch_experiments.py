"""The port's experiment sweeps and result archives held to the JAX package.

At the TINY widths of ``tests/test_experiments.py``: archives written by
either package (npz, and hickle layouts written by either ``save_hkl``)
load in the other with equal matrices, blocks, names and values;
``restricted_to_trials`` and the sweeps' bookkeeping (the subsets drawn,
the seconds of speech, the grid's cells) equal JAX's, with ``fit`` and
``assess`` replaced by the same stubs in both packages; one real tiny
sweep of the port whose archives JAX's readers load; ``torch_learn``
(``fit`` under the JAX engine's name).
"""

import os

import numpy as np
import pytest
import torch

from ecog2txt_tpu import experiments as jexp
from ecog2txt_tpu import train as jtrain
from ecog2txt_tpu.demo import make_demo_experiment as jmake_demo
from ecog2txt_tpu.plotting import gridsearch as jgrid
from ecog2txt_tpu.plotting import hkl as jhkl
from ecog2txt_tpu.plotting import results as jresults
from ecog2txt_tpu_torch import experiments as texp
from ecog2txt_tpu_torch import train as ttrain
from ecog2txt_tpu_torch.convert import tree_leaves
from ecog2txt_tpu_torch.demo import make_demo_experiment
from ecog2txt_tpu_torch.plotting import gridsearch as tgrid
from ecog2txt_tpu_torch.plotting import hkl as thkl
from ecog2txt_tpu_torch.plotting import results as tresults
from torch_threads import one_torch_thread  # noqa: F401

TINY = {
    "encoder_embedding": [16],
    "encoder_rnn": [24],
    "encoder_1_projection": [16],
    "decoder_embedding": [12],
    "decoder_rnn": [48],
    "decoder_projection": [],
}
SN = {"batch_size": 16, "max_dec_len": 10, "N_epochs": 2, "temperature": 0.0}
PACKAGES = {
    "jax": (jresults, jgrid, jhkl),
    "port": (tresults, tgrid, thkl),
}


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """Byte-identical demo experiments, one for each package."""
    root = tmp_path_factory.mktemp("sweeps")
    return (make_demo_experiment(str(root / "t"), subject_ids=(1,), layer_sizes=TINY),
            jmake_demo(str(root / "j"), subject_ids=(1,), layer_sizes=TINY))


def _port(manifest, **sn):
    return ttrain.MultiSubjectTrainer(manifest, [1], SN_kwargs={**SN, "use_pallas_lstm": True,
                                                                **sn},
                                      VERBOSE=False, device="cpu")


def _jax(manifest, **sn):
    return jtrain.MultiSubjectTrainer(manifest, [1], SN_kwargs={**SN, "use_pallas_lstm": False,
                                                                **sn},
                                      VERBOSE=False)


@pytest.fixture(scope="module")
def trainers(manifests):
    return _port(manifests[0]), _jax(manifests[1])


# --------------------------------------------------------------------------
# restricted trainers
# --------------------------------------------------------------------------


def test_restricted_to_trials_matches_jax(trainers):
    tr, jtr = trainers
    sub, jsub = tr.restricted_to_trials([0, 2, 5]), jtr.restricted_to_trials([0, 2, 5])
    assert sub.device == tr.device
    got, want = sub.packed_dataset("training"), jsub.packed_dataset("training")
    assert int(got.num_trials[0]) == int(want.num_trials[0]) == 3
    np.testing.assert_array_equal(got.encoder_inputs, want.encoder_inputs)
    np.testing.assert_array_equal(got.encoder_lengths, want.encoder_lengths)
    np.testing.assert_array_equal(got.decoder_targets, want.decoder_targets)
    assert got.references == want.references
    assert int(sub.packed_dataset("validation").num_trials[0]) == 10


def test_restricted_trainer_keeps_the_device_and_the_overrides(trainers):
    """A grid cell is the base trainer on its device with only the
    overrides changed (without the device every cell would ask for a
    card)."""
    tr, _ = trainers
    cell = texp._restricted_trainer(tr, learning_rate=3e-3, batch_size=8)
    assert cell.device == tr.device
    assert cell.learning_rate == 3e-3 and cell.batch_size == 8
    assert cell.SN_kwargs == {**tr.SN_kwargs, "learning_rate": 3e-3, "batch_size": 8}
    assert cell.net_config == tr.net_config
    assert tr.SN_kwargs.get("learning_rate") is None  # the base is untouched


# --------------------------------------------------------------------------
# the sweeps' bookkeeping, with fit and assess stubbed in both packages
# --------------------------------------------------------------------------


def _stub(monkeypatch, cls, log):
    """``fit`` and ``assess`` of ``cls`` replaced: fit records the cell,
    assess returns metrics that are a function of the cell."""

    def fit(self, num_epochs=None, assess=True, **kw):
        subset = sorted(int(i) for v in self._trial_subset.values() for i in v)
        log.append((subset, num_epochs, assess, self.learning_rate, self.batch_size))
        return {}

    def assess(self, partitions=("training", "validation"), **kw):
        subset = [int(i) for v in self._trial_subset.values() for i in v]
        wer = (sum(subset) % 97) / 97 + self.learning_rate + self.batch_size / 1000
        return {p: {"word_error_rate": wer, "accuracy": 1.0 - wer / 2} for p in partitions}

    monkeypatch.setattr(cls, "fit", fit)
    monkeypatch.setattr(cls, "assess", assess)


def _archive(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("sweep", ["perf", "perf_max_host", "grid"])
def test_sweep_bookkeeping_matches_jax(sweep, manifests, monkeypatch):
    """The same cells in the same order (subsets from the same generator
    draws), the same seconds of speech and validation blocks, and the
    archives equal key by key, exactly."""
    sn = {"max_host_trials": 8} if sweep == "perf_max_host" else {}
    tr, jtr = _port(manifests[0], **sn), _jax(manifests[1], **sn)
    logs = {"port": [], "jax": []}
    _stub(monkeypatch, ttrain.MultiSubjectTrainer, logs["port"])
    _stub(monkeypatch, jtrain.MultiSubjectTrainer, logs["jax"])
    if sweep == "grid":
        grid = {"learning_rate": [1e-3, 3e-3], "batch_size": [8, 16, 32]}
        paths = [texp.grid_search(tr, grid, num_epochs=3, suffix="stub"),
                 jexp.grid_search(jtr, grid, num_epochs=3, suffix="stub")]
        assert len(logs["port"]) == 6
    else:
        kw = dict(num_folds=3, fractions=(0.25, 0.5, 1.0), num_epochs=3, suffix="stub",
                  seed=7)
        paths = [texp.perf_vs_training_size(tr, **kw), jexp.perf_vs_training_size(jtr, **kw)]
        assert len(logs["port"]) == 9
        assert [len(c[0]) for c in logs["port"][:3]] == [10, 20, 40]
    assert logs["port"] == logs["jax"]
    assert [os.path.basename(p) for p in paths] == [
        f"{'grid_search' if sweep == 'grid' else 'perf_vs_training_size'}_1_stub.npz"] * 2
    got, want = (_archive(p) for p in paths)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    if sweep != "grid":
        assert np.all(np.diff(got["nums_seconds"], axis=1) > 0)


# --------------------------------------------------------------------------
# one real sweep of the port, read by JAX's readers
# --------------------------------------------------------------------------


def test_real_tiny_sweeps_load_in_jax(trainers):
    tr, _ = trainers
    path = texp.perf_vs_training_size(tr, num_folds=1, fractions=(0.5, 1.0), num_epochs=1,
                                      suffix="real")
    results_dir = tr.manifest.resolve("saved_results_dir")
    for res in (jresults.DecodingResults(results_dir, 1, "real"),
                tresults.DecodingResults("", "", path=path)):
        assert res.word_error_rate.shape == (1, 2)
        assert np.isfinite(np.asarray(res.word_error_rate)).all()
        assert np.isfinite(np.asarray(res.accuracy)).all()
        assert res.nums_seconds[0, 1] > res.nums_seconds[0, 0] > 0
        assert res.validation_blocks == [5]
    gpath = texp.grid_search(tr, {"learning_rate": [1e-3, 3e-3]}, num_epochs=1, suffix="real")
    gs, tgs = jgrid.GridSearchResults(gpath), tgrid.GridSearchResults(gpath)
    assert gs.wers.shape == (2,) and np.isfinite(gs.wers).all()
    np.testing.assert_array_equal(tgs.wers, gs.wers)
    assert gs.best()["learning_rate"] in (1e-3, 3e-3)
    assert tgs.best() == gs.best()


# --------------------------------------------------------------------------
# archives across the packages
# --------------------------------------------------------------------------

WER = np.array([[0.9, 0.5, 0.2], [0.8, 0.6, 0.3]])
BLOCKS = [[1], [1, 2], [1, 2, 3], [2], [2, 3], [1, 2, 3]]


def _write_decoding(writer: str, fmt: str, path: str) -> str:
    results, _, hkl = PACKAGES[writer]
    if fmt == "npz":
        return results.save_decoding_results(path, WER, 1 - WER, WER * 100,
                                             training_blocks=BLOCKS[:2],
                                             validation_blocks=[5, 6])
    # the reference's layout: a tuple wrapper, flattened fold × datasize
    # entries, one block list per entry
    return hkl.save_hkl(path, ({
        "word_error_rate": WER.ravel(), "accuracy": 1 - WER.ravel(),
        "nums_seconds": WER.ravel() * 100,
        "training_blocks": [np.asarray(b) for b in BLOCKS],
        "validation_blocks": [5, 6],
    },))


def _write_grid(writer: str, fmt: str, path: str) -> str:
    _, grid, hkl = PACKAGES[writer]
    lrs, bss = np.array([1e-4, 1e-3]), np.array([16.0, 32, 64])
    wers = np.array([[0.5, 0.4, 0.3], [0.6, 0.2, 0.25]])
    if fmt == "npz":
        return grid.save_grid_search(path, ["learning_rate", "batch_size"], [lrs, bss], wers)
    g_lr, g_bs = np.meshgrid(lrs, bss, indexing="ij")
    return hkl.save_hkl(path, ({"word_error_rate": wers.ravel()},
                               ["learning_rate", "batch_size"], [g_lr.ravel(), g_bs.ravel()]))


@pytest.mark.parametrize("fmt", ["npz", "hkl"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["decoding", "grid"])
def test_archives_load_in_both_packages(kind, writer, fmt, tmp_path):
    """An archive either package writes loads in both with equal
    contents; the hickle loader reshapes flattened entries by the number
    of distinct training sizes in both."""
    if kind == "decoding":
        path = _write_decoding(writer, fmt, str(tmp_path / "perf_vs_training_size_1_x"))
        assert os.path.exists(path)
        got = tresults.DecodingResults(str(tmp_path), 1, "x")
        want = jresults.DecodingResults(str(tmp_path), 1, "x")
        for key in ("word_error_rate", "accuracy", "nums_seconds"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
            assert type(getattr(got, key)).__name__ == "ResultsMatrix"
        assert got.training_blocks == want.training_blocks
        assert got.validation_blocks == want.validation_blocks == [5, 6]
        assert got.word_error_rate.shape == (2, 3)
        np.testing.assert_array_equal(np.asarray(got.word_error_rate), WER)
        for key in ("training_minutes", "wer_mean", "wer_stderr", "accuracy_mean"):
            np.testing.assert_array_equal(got.summary()[key], want.summary()[key])
        assert (got.num_folds, got.num_datasizes) == (want.num_folds, want.num_datasizes)
    else:
        path = _write_grid(writer, fmt, str(tmp_path / "grid_search_1_x"))
        got, want = tgrid.GridSearchResults(path), jgrid.GridSearchResults(path)
        assert got.param_names == want.param_names == ["learning_rate", "batch_size"]
        np.testing.assert_array_equal(got.wers, want.wers)
        for name in want.param_names:
            np.testing.assert_array_equal(got.param_values[name], want.param_values[name])
        assert got.best() == want.best()


def test_hkl_legacy_layouts_load_alike(tmp_path):
    """Hand-written reference layouts: repr-quoted keys, ``item_N``
    children, per-epoch result columns, per-entry validation blocks."""
    import h5py

    wer = np.array([0.9, 0.5, 0.2, 0.8, 0.6, 0.3])
    per_epoch = np.stack([wer + 0.1, wer], axis=1)  # the last column counts
    path = str(tmp_path / "perf_vs_training_size_9_v3.hkl")
    with h5py.File(path, "w") as f:
        entry = f.create_group("data").create_group("data_0")
        entry.create_dataset("'word_error_rate'", data=per_epoch)
        entry.create_dataset("'accuracy'", data=1 - wer)
        entry.create_dataset("'nums_seconds'", data=wer * 60)
        tb = entry.create_group("'training_blocks'")
        for i, b in enumerate(BLOCKS):
            tb.create_dataset(f"item_{i}", data=np.asarray(b))
        vb = entry.create_group("'validation_blocks'")
        for i in range(6):
            vb.create_dataset(f"item_{i}", data=np.asarray([5, 6 + i % 2]))
    got = tresults.DecodingResults(str(tmp_path), 9, "v3")
    want = jresults.DecodingResults(str(tmp_path), 9, "v3")
    np.testing.assert_array_equal(got.word_error_rate, want.word_error_rate)
    np.testing.assert_array_equal(got.word_error_rate, wer.reshape(2, 3))
    assert got.training_blocks == want.training_blocks == BLOCKS
    assert got.validation_blocks == want.validation_blocks == [5, 6, 7]
    back, jback = thkl.load_hkl(path), jhkl.load_hkl(path)
    assert isinstance(back, list) and sorted(back[0]) == sorted(jback[0])
    np.testing.assert_array_equal(back[0]["word_error_rate"], jback[0]["word_error_rate"])


def test_hkl_nested_round_trip_matches_jax(tmp_path):
    obj = {"matrix": np.arange(6.0).reshape(2, 3), "names": ["alpha", "beta"],
           "nested": {"k": np.asarray([1, 2, 3])}, "single": [np.arange(2.0)]}
    got = thkl.load_hkl(thkl.save_hkl(str(tmp_path / "t"), obj))
    want = jhkl.load_hkl(jhkl.save_hkl(str(tmp_path / "j"), obj))
    np.testing.assert_array_equal(got["matrix"], want["matrix"])
    assert list(got["names"]) == list(want["names"]) == ["alpha", "beta"]
    np.testing.assert_array_equal(got["nested"]["k"], want["nested"]["k"])
    assert isinstance(got["single"], list) and len(got["single"]) == 1
    # each package reads the other's file alike
    np.testing.assert_array_equal(jhkl.load_hkl(str(tmp_path / "t.hkl"))["matrix"],
                                  thkl.load_hkl(str(tmp_path / "j.hkl"))["matrix"])


# --------------------------------------------------------------------------
# torch_learn
# --------------------------------------------------------------------------


def test_torch_learn_is_fit(manifests):
    """``torch_learn`` returns ``fit``'s history (the same keys at every
    level) and trains as ``fit`` does, bit for bit; another device than
    the trainer's raises."""
    a, b = _port(manifests[0]), _port(manifests[0])
    history = a.torch_learn(N_epochs=2, device="cpu", push_weights=True)
    want = b.fit(num_epochs=2)
    assert list(history) == list(want) == ["2"]
    for epoch in want:
        assert sorted(history[epoch]) == sorted(want[epoch])
        for part in want[epoch]:
            assert sorted(history[epoch][part]) == sorted(want[epoch][part])
            assert history[epoch][part]["word_error_rate"] == want[epoch][part]["word_error_rate"]
    assert int(a.state.epoch) == int(b.state.epoch) == 2
    for x, y in zip(tree_leaves(a.state.params), tree_leaves(b.state.params)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="not the trainer's"):
        a.torch_learn(N_epochs=1, device="meta")
