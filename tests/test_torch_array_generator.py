"""The port's file-backed ``ArrayDataGenerator`` held to the JAX package.

The same per-trial ``.npz`` / ``.mat`` files under ``tmp_path`` go through
both packages' generators: block discovery, the trial count, channel
referencing (bad electrodes, bipolar pairs), tokenized text, and raw
voltages featurized through each package's high-gamma chain (the port's
on ``device="cpu"``) with ``hg_zscore`` 'trial' and 'block', int16 input
scaled before referencing, and the rate from the file or the manifest:
frames at f32 rtol 1e-4 / atol 1e-5, everything else exactly.  Then
``export_trials_to_arrays`` round trips and ``filter_to_common_targets``.
"""

import os

import numpy as np
import pytest
from scipy.io import savemat

from ecog2txt_tpu import datagen as jd
from ecog2txt_tpu.config import Manifest as JManifest
from ecog2txt_tpu_torch import datagen as td
from ecog2txt_tpu_torch.config import Manifest
from ecog2txt_tpu_torch.features import extract_high_gamma_np
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
HG = {"num_bands": 4, "pad_seconds": 0.25}  # a small chain, as the JAX tests use


def _manifest(trial_dir, **over):
    base = {"grid_size": [2, 2], "grid_step": 1, "sampling_rate": 200,
            "token_type": "word_sequence", "trial_dir": trial_dir,
            "tf_record_partial_path": os.path.join(trial_dir, "rec", "s_B{0}.tfrecord")}
    base.update(over)
    return base


def _both(d, kw=None, **over):
    """The port's generator (on the CPU) and JAX's over the same files."""
    kw = kw or {}
    m = _manifest(d, **over)
    return (td.ArrayDataGenerator(Manifest(m, 1), 1, device="cpu", **kw),
            jd.ArrayDataGenerator(JManifest(m, 1), 1, **kw))


def _assert_same_trials(port, jax_gen, block, frames=F32):
    got, want = list(port._ecog_token_generator(block)), list(jax_gen._ecog_token_generator(block))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["ecog_sequence"].shape == w["ecog_sequence"].shape
        np.testing.assert_allclose(g["ecog_sequence"], w["ecog_sequence"], **frames)
        assert g["text_sequence"] == w["text_sequence"]
        assert g["phoneme_sequence"] == w["phoneme_sequence"]
        np.testing.assert_array_equal(g["audio_sequence"], w["audio_sequence"])
    return got


def _save_raw(path, raw, text, rate=None, **extra):
    arrays = {"raw": raw, "text": text, **extra}
    if rate is not None:
        arrays["raw_rate"] = rate
    np.savez(path, **arrays)


def test_discovery_referencing_and_mat_files(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "B3"))
    os.makedirs(os.path.join(d, "B2"))
    T = 6
    ecog = np.arange(T * 6, dtype=np.float32).reshape(T, 6)
    np.savez(os.path.join(d, "B3", "a.npz"), ecog=ecog, text="hi there",
             phonemes=np.array(["h"] * T))
    np.savez(os.path.join(d, "B5_t0.npz"), ecog=np.zeros((10, 5), np.float32), text="yo")
    savemat(os.path.join(d, "B2", "t.mat"), {"ecog": np.ones((8, 5), np.float32),
                                             "text": "dog ate"})
    port, jax_gen = _both(d, {"bad_electrodes": [0]}, grid_size=[2, 3])
    assert port._all_blocks() == jax_gen._all_blocks() == [2, 3, 5]
    assert port._query([2, 3, 5]) == 3 and port.num_ECoG_channels == 5
    for block in (2, 3, 5):
        _assert_same_trials(port, jax_gen, block, frames=dict(rtol=0, atol=0))
    port, jax_gen = _both(d, grid_size=[2, 3], REFERENCE_BIPOLAR=True)
    _assert_same_trials(port, jax_gen, 3, frames=dict(rtol=0, atol=0))
    np.savez(os.path.join(d, "B3", "b.npz"), ecog=np.zeros((5, 7), np.float32), text="a")
    port, _ = _both(d, grid_size=[2, 3])
    with pytest.raises(ValueError, match="7 columns"):
        list(port._ecog_token_generator(3))
    with pytest.raises(ValueError, match="trial_dir"):
        td.ArrayDataGenerator(Manifest(_manifest(""), 1), 1, device="cpu")


@pytest.mark.parametrize("hg_zscore", ["trial", "block"])
def test_raw_trials_match_jax(tmp_path, hg_zscore):
    """Raw trials beside a featurized one in the same block: each package's
    chain, z-scored per trial or with statistics pooled over the block's
    raw trials."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "B1"))
    rng = np.random.default_rng(1)
    for i in range(3):
        raw = rng.normal(size=(800 + 100 * i, 4)).astype(np.float32) * (i + 1)
        _save_raw(os.path.join(d, "B1", f"t{i}.npz"), raw, "hi there", 1000.0)
    np.savez(os.path.join(d, "B1", "z.npz"), ecog=np.ones((10, 4), np.float32), text="yo")
    port, jax_gen = _both(d, {"hg_zscore": hg_zscore}, high_gamma=HG)
    cfg = port.high_gamma_config(1000.0)
    assert cfg.zscore == ("none" if hg_zscore == "block" else "trial")
    assert cfg.out_rate == 200.0
    got = _assert_same_trials(port, jax_gen, 1)
    assert got[0]["ecog_sequence"].shape == (160, 4)  # q = 5
    if hg_zscore == "block":
        frames = np.concatenate([t["ecog_sequence"] for t in got[:3]])
        np.testing.assert_allclose(frames.mean(0), 0.0, atol=1e-4)
        np.testing.assert_allclose(frames.std(0), 1.0, atol=1e-3)
    else:
        raw = np.load(os.path.join(d, "B1", "t0.npz"))["raw"]
        np.testing.assert_allclose(got[0]["ecog_sequence"],
                                   extract_high_gamma_np(raw, cfg, device="cpu"),
                                   rtol=1e-5, atol=1e-6)


def test_raw_int16_manifest_rate_referencing_and_errors(tmp_path):
    """int16 columns scaled by ``input_scale`` before referencing, the rate
    from the manifest; a raw trial without a rate and an unknown
    ``hg_zscore`` raise."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "B1"))
    raw = (np.random.default_rng(2).normal(size=(1000, 4)) * 3000).astype(np.int16)
    _save_raw(os.path.join(d, "B1", "t.npz"), raw, "a")
    port, jax_gen = _both(d, {"bad_electrodes": [0]}, raw_sampling_rate=1000.0,
                          high_gamma=dict(HG, input_scale=1e-4))
    assert port.num_ECoG_channels == 3
    _assert_same_trials(port, jax_gen, 1)
    port, _ = _both(d)
    with pytest.raises(ValueError, match="raw_rate"):
        list(port._ecog_token_generator(1))
    with pytest.raises(ValueError, match="hg_zscore"):
        td.ArrayDataGenerator(Manifest(_manifest(d), 1), 1, hg_zscore="global", device="cpu")


def test_export_round_trip_and_common_targets(tmp_path):
    """``export_trials_to_arrays`` writes the generator's trials as files an
    ``ArrayDataGenerator`` reads back unchanged (and equal to JAX's export);
    ``filter_to_common_targets`` keeps the targets both sets share."""
    d = str(tmp_path / "src")
    os.makedirs(os.path.join(d, "B1"))
    rng = np.random.default_rng(3)
    for i in range(2):
        np.savez(os.path.join(d, "B1", f"{i}.npz"), ecog=rng.normal(size=(9, 4)).astype(np.float32),
                 text="a b", audio_features=rng.normal(size=(9, 3)).astype(np.float32))
    port, jax_gen = _both(d)
    assert td.export_trials_to_arrays(port, str(tmp_path / "out")) == 2
    assert jd.export_trials_to_arrays(jax_gen, str(tmp_path / "jout")) == 2
    for name in ("0000.npz", "0001.npz"):
        a = np.load(tmp_path / "out" / "B1" / name)
        b = np.load(tmp_path / "jout" / "B1" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    back, _ = _both(str(tmp_path / "out"))
    before = list(port._ecog_token_generator(1))
    for g, w in zip(back._ecog_token_generator(1), before):
        np.testing.assert_array_equal(g["ecog_sequence"], w["ecog_sequence"])
        assert g["text_sequence"] == w["text_sequence"]
    xa, xb = np.arange(12.0).reshape(3, 2, 2), np.arange(8.0).reshape(2, 2, 2)
    ta, tb = ["x", ["y", "z"], "w"], [["y", "z"], "q"]
    got = td.filter_to_common_targets(xa, ta, xb, tb)
    want = jd.filter_to_common_targets(xa, ta, xb, tb)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got[1] == [["y", "z"]]
