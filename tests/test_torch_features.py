"""The port's raw-voltage → high-gamma front end held to the JAX package.

``features.py`` against ``ecog2txt_tpu/features.py`` on seeded numpy
signals, on the CPU (``device="cpu"``; the card's run is in
``chip_smoke.py`` and ``tests/test_torch_gpu.py``): the FFT length, masks
and taps; ``band_envelopes``, ``decimate_envelope`` and
``extract_high_gamma`` (trial and no z-score, float and int16 input)
against JAX's chain at f32 rtol 1e-4 / atol 1e-5, and against the scipy
and numpy oracles of ``tests/test_features.py`` at their tolerances;
``StreamingHighGamma`` (ragged float and int16 pushes) against the offline
chain and JAX's stream, calibration statistics applied and equal to
JAX's; the synthetic raw voltage and its recovered envelope.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecog2txt_tpu import features as jf
from ecog2txt_tpu_torch import features as tf
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-4, atol=1e-5)
CFG = tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="none")
JCFG = jf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="none")


def _raw(T=4000, C=4, seed=0):
    return np.random.default_rng(seed).standard_normal((T, C)).astype(np.float32)


def _jcfg(cfg):
    return jf.HighGammaConfig(**cfg.__dict__)


def test_constants_equal_the_jax_packages():
    for n in [1, 7, 13, 100, 1023, 1025, 4001, 35200, 48000, 59049]:
        assert tf._next_fast_len(n) == jf._next_fast_len(n), n
    for n_fft in (2000, 2025):
        np.testing.assert_array_equal(tf._analytic_band_masks(n_fft, CFG),
                                      jf._analytic_band_masks(n_fft, JCFG))
    for q in (1, 5, 16):
        np.testing.assert_array_equal(tf._decimation_taps(q), jf._decimation_taps(q))
    assert CFG.decimation == 10 and CFG.pad_samples == 500
    np.testing.assert_array_equal(CFG.center_freqs, JCFG.center_freqs)


def test_band_envelope_matches_jax_and_scipy_hilbert():
    """The bank's mean envelope against JAX's (f32); one band against
    |scipy.signal.hilbert| of the same real filter (the oracle of
    ``tests/test_features.py``, its tolerance)."""
    from scipy.signal import hilbert

    x = _raw(T=2000, C=3)
    got = tf.band_envelopes(torch.from_numpy(x), CFG).numpy()
    np.testing.assert_allclose(got, np.asarray(jf.band_envelopes(jnp.asarray(x), JCFG)), **F32)
    T = len(x)
    one = tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="none", num_bands=1,
                             band=(CFG.center_freqs[3], CFG.center_freqs[3] + 1e-9))
    got = tf.band_envelopes(torch.from_numpy(x), one).numpy()
    nf = tf._next_fast_len(T)
    mag = np.abs(tf._analytic_band_masks(nf, one)[0])
    h = np.zeros(nf)
    h[0] = 1.0
    h[nf // 2] = 1.0
    h[1: nf // 2] = 2.0
    real_mag = np.where(h > 0, mag / np.maximum(h, 1e-30), 0.0)
    sym = real_mag + np.roll(real_mag[::-1], 1)
    sym[0], sym[nf // 2] = real_mag[0], real_mag[nf // 2]
    filt = np.real(np.fft.ifft(np.fft.fft(x, n=nf, axis=0) * sym[:, None], axis=0))[:T]
    want = np.abs(hilbert(filt, N=nf, axis=0))[:T]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_decimate_matches_jax_and_numpy_convolve():
    q = CFG.decimation
    hg = np.abs(_raw(T=3000, C=2, seed=1))
    got = tf.decimate_envelope(torch.from_numpy(hg), CFG).numpy()
    assert got.dtype == np.float32 and got.shape == (300, 2)
    np.testing.assert_allclose(got, np.asarray(jf.decimate_envelope(jnp.asarray(hg), JCFG)), **F32)
    taps = tf._decimation_taps(q)
    want = np.stack([np.convolve(hg[:, c], taps, "same")[::q] for c in range(2)], axis=1)
    np.testing.assert_allclose(got, want[: len(got)], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("zscore,T", [("none", 2000), ("trial", 2000), ("trial", 137),
                                      ("none", 23)])
def test_extract_matches_jax(zscore, T):
    """The whole chain (reflect margin, shrinking below the margin on short
    trials), f32; the trial z-score also against scipy's (ddof 0)."""
    from scipy import stats

    cfg = tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore=zscore)
    x = _raw(T=T, C=3, seed=3)
    got = tf.extract_high_gamma_np(x, cfg, device="cpu")
    want = np.asarray(jf.extract_high_gamma(jnp.asarray(x), _jcfg(cfg)))
    assert got.shape == want.shape == (T // 10, 3)
    np.testing.assert_allclose(got, want, **F32)
    if zscore == "trial" and T == 2000:
        raw_feats = tf.extract_high_gamma_np(x, CFG, device="cpu")
        np.testing.assert_allclose(got, stats.zscore(raw_feats, axis=0), rtol=1e-3, atol=1e-4)


def test_extract_accepts_int16_and_needs_a_device():
    x = _raw(T=1000, C=2, seed=5)
    xi = np.clip(x * 1000, -32768, 32767).astype(np.int16)
    cfg = tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="none",
                             input_scale=1.0 / 1000.0)
    got = tf.extract_high_gamma_np(xi, cfg, device="cpu")
    np.testing.assert_allclose(
        got, tf.extract_high_gamma_np(xi.astype(np.float32) / 1000.0, cfg, device="cpu"), **F32)
    np.testing.assert_allclose(
        got, np.asarray(jf.extract_high_gamma(jnp.asarray(xi), _jcfg(cfg))), **F32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tf.extract_high_gamma_np(xi, cfg)  # the default device is the card


def _stream(stream, raw, rng):
    outs, pos = [], 0
    while pos < len(raw):
        n = int(rng.integers(50, 700))
        outs.append(stream.push(raw[pos: pos + n]))
        pos += n
    outs.append(stream.flush())
    return np.concatenate(outs)


@pytest.mark.parametrize("T", [6000, 1234])
def test_streaming_matches_offline_and_jax(T):
    """Ragged pushes reproduce the offline chain (the tolerance of
    ``tests/test_features.py``) and JAX's stream (f32); int16 pushes keep
    the buffer int16 and equal the float stream of the scaled samples."""
    raw = _raw(T=T, C=3, seed=6)
    offline = tf.extract_high_gamma_np(raw, CFG, device="cpu")
    got = _stream(tf.StreamingHighGamma(CFG, 3, window_seconds=1.0, device="cpu"), raw,
                  np.random.default_rng(6))
    assert got.shape == offline.shape
    scale = np.abs(offline).mean()
    np.testing.assert_allclose(got, offline, rtol=5e-3, atol=5e-3 * scale)
    want = _stream(jf.StreamingHighGamma(JCFG, 3, window_seconds=1.0), raw,
                   np.random.default_rng(6))
    np.testing.assert_allclose(got, want, **F32)
    cfg = tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="none", input_scale=1e-3)
    ints = np.clip(raw * 1000, -32768, 32767).astype(np.int16)
    stream = tf.StreamingHighGamma(cfg, 3, window_seconds=1.0, device="cpu")
    first = stream.push(ints[:1700])
    assert stream._buf.dtype == np.int16
    got_i = np.concatenate([first, _stream(stream, ints[1700:], np.random.default_rng(7))])
    floats = ints.astype(np.float32) * np.float32(1e-3)
    want_f = _stream(tf.StreamingHighGamma(cfg, 3, window_seconds=1.0, device="cpu"), floats,
                     np.random.default_rng(8))
    np.testing.assert_allclose(got_i, want_f, **F32)


def test_calibration_stats_match_jax_and_apply():
    raws = [_raw(T=1500, C=2, seed=s) for s in (7, 8)]
    mu, sd = tf.calibrate_high_gamma(raws, CFG, device="cpu")
    jmu, jsd = jf.calibrate_high_gamma(raws, JCFG)
    np.testing.assert_allclose(mu, jmu, **F32)
    np.testing.assert_allclose(sd, jsd, **F32)
    plain = tf.StreamingHighGamma(CFG, 2, window_seconds=1.0, device="cpu")
    calib = tf.StreamingHighGamma(CFG, 2, window_seconds=1.0, stats=(mu, sd), device="cpu")
    a = np.concatenate([plain.push(raws[0]), plain.flush()])
    b = np.concatenate([calib.push(raws[0]), calib.flush()])
    np.testing.assert_allclose(b, (a - mu) / sd, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="at least one frame"):
        tf.calibrate_high_gamma([], CFG, device="cpu")


def test_synthetic_raw_equals_jax_and_recovers_its_envelope():
    T_out, C = 200, 4
    t = np.arange(T_out)[:, None] / 50.0
    envelope = ((1.0 + np.sin(2 * np.pi * 0.5 * t + np.arange(C)[None, :])) * 0.5
                + 0.2).astype(np.float32)
    raw = tf.synthesize_raw_from_envelope(envelope, CFG, np.random.default_rng(4))
    np.testing.assert_array_equal(
        raw, jf.synthesize_raw_from_envelope(envelope, JCFG, np.random.default_rng(4)))
    feats = tf.extract_high_gamma_np(raw, CFG, device="cpu")
    assert feats.shape == (T_out, C)
    k = np.ones(11) / 11.0
    for c in range(C):
        r = np.corrcoef(np.convolve(feats[:, c], k, "same")[15:-15], envelope[15:-15, c])[0, 1]
        assert r > 0.9, f"channel {c}: corr {r:.3f}"


def test_config_validation():
    with pytest.raises(ValueError, match="integer multiple"):
        tf.HighGammaConfig(raw_rate=1000.0, out_rate=300.0)
    with pytest.raises(ValueError, match="raw_rate"):
        tf.HighGammaConfig(raw_rate=200.0, out_rate=100.0)
    with pytest.raises(ValueError, match="zscore"):
        tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0, zscore="block")
    with pytest.raises(ValueError, match="zscore='none'"):
        tf.StreamingHighGamma(tf.HighGammaConfig(raw_rate=1000.0, out_rate=100.0), 2,
                              device="cpu")
    with pytest.raises(ValueError, match="margin"):
        tf.StreamingHighGamma(CFG, 2, window_seconds=0.1, device="cpu")
