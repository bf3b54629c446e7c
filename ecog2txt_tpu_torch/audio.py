"""Audio featurization: mel filterbank energies, MFCCs, deltas.

Drop-in replacement for the ``python_speech_features`` calls in the
reference's ``_get_MFCC_features`` (reference data_generators.py:328-380),
implemented from the standard definitions (Davis & Mermelstein MFCCs,
HTK-style mel scale) in numpy.  The reference's exact configuration:

* ``fbank`` with 26 mel filters, ``winlen = mfcc_winlen`` (0.02 s),
  ``winstep = 1/ecog_rate`` so one audio frame per ECoG sample,
  preemphasis 0.97, nfft 512, **rectangular window**;
* then either append log-energy to the log-mels (``USE_LOG_MELS``) or
  DCT-II(ortho) → keep ``num_cepstral_coeffs`` → lifter (ceplifter 22) →
  replace c0 with log-energy;
* optional delta features (N=2) concatenated (``USE_MFCC_DELTAS``).

These run on the host at featurization time (results are stored in
records); they are NOT in the training hot path.

The port's own copy of ``ecog2txt_tpu/audio.py`` (plain Python and numpy,
no JAX), with the same names and behaviour.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.fftpack import dct

EPS = np.finfo(np.float64).eps


def _round_half_up(x: float) -> int:
    """Round half away from zero (python_speech_features rounds frame
    lengths with decimal ROUND_HALF_UP; Python's round() is banker's —
    the two differ at exact .5 boundaries, e.g. winlen·rate = 312.5)."""
    return int(math.floor(x + 0.5))


# --------------------------------------------------------------------------
# framing + spectra
# --------------------------------------------------------------------------


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def preemphasize(signal: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    signal = np.asarray(signal, dtype=np.float64)
    if coeff == 0.0:
        return signal
    return np.append(signal[0], signal[1:] - coeff * signal[:-1])


def frame_signal(
    signal: np.ndarray, frame_len: int, frame_step: int
) -> np.ndarray:
    """Slice a 1-D signal into overlapping frames, zero-padding the tail
    so the last partial frame is kept (``ceil`` frame count, matching
    python_speech_features.sigproc.framesig)."""
    signal = np.asarray(signal, dtype=np.float64)
    n = len(signal)
    if n <= frame_len:
        num_frames = 1
    else:
        num_frames = 1 + int(math.ceil((n - frame_len) / frame_step))
    pad_len = (num_frames - 1) * frame_step + frame_len
    padded = np.concatenate([signal, np.zeros(pad_len - n)])
    idx = (
        np.arange(frame_len)[None, :]
        + np.arange(num_frames)[:, None] * frame_step
    )
    return padded[idx]


def power_spectrum(frames: np.ndarray, nfft: int) -> np.ndarray:
    """1/NFFT * |rfft|^2 per frame."""
    return np.square(np.abs(np.fft.rfft(frames, nfft))) / nfft


def mel_filterbank(
    nfilt: int,
    nfft: int,
    samplerate: float,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank, (nfilt, nfft//2+1)."""
    highfreq = highfreq or samplerate / 2.0
    mel_points = np.linspace(hz_to_mel(lowfreq), hz_to_mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz(mel_points) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank


# --------------------------------------------------------------------------
# feature chains
# --------------------------------------------------------------------------


def fbank_features(
    signal: np.ndarray,
    samplerate: float,
    winlen: float = 0.02,
    winstep: float = 0.005,
    nfilt: int = 26,
    nfft: int = 512,
    preemph: float = 0.97,
) -> tuple[np.ndarray, np.ndarray]:
    """Mel-filterbank energies + per-frame total energy.

    Rectangular window (the reference's explicit winfunc lambda,
    data_generators.py:357-361).  Returns (feat (T, nfilt), energy (T,)).
    """
    signal = preemphasize(signal, preemph)
    frames = frame_signal(
        signal,
        _round_half_up(winlen * samplerate),
        _round_half_up(winstep * samplerate),
    )
    pspec = power_spectrum(frames, nfft)
    energy = np.where(pspec.sum(axis=1) == 0, EPS, pspec.sum(axis=1))
    fb = mel_filterbank(nfilt, nfft, samplerate)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, EPS, feat)
    return feat, energy


def lifter(cepstra: np.ndarray, L: int = 22) -> np.ndarray:
    """Sinusoidal cepstral liftering."""
    if L <= 0:
        return cepstra
    n = np.arange(cepstra.shape[1])
    return cepstra * (1.0 + (L / 2.0) * np.sin(np.pi * n / L))


def delta_features(feat: np.ndarray, N: int = 2) -> np.ndarray:
    """Delta (first-difference) features over ±N frames with edge
    padding; denominator 2·Σ i²."""
    if N < 1:
        raise ValueError("N must be >= 1")
    T = feat.shape[0]
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    padded = np.pad(feat, ((N, N), (0, 0)), mode="edge")
    out = np.zeros_like(feat)
    for t in range(T):
        window = padded[t : t + 2 * N + 1]
        out[t] = np.arange(-N, N + 1) @ window / denom
    return out


def mfcc_chain(
    signal: np.ndarray,
    samplerate: float,
    winlen: float = 0.02,
    winstep: float = 0.005,
    num_mel_features: int = 26,
    num_cepstral_coeffs: int = 13,
    USE_LOG_MELS: bool = False,
    USE_MFCC_DELTAS: bool = False,
    nfft: int = 512,
    preemph: float = 0.97,
    ceplifter: int = 22,
) -> np.ndarray:
    """The reference's full MFCC pipeline (data_generators.py:328-380):

    fbank → log → (a) log-mels with log-energy appended, or (b) DCT-II
    ortho, keep ``num_cepstral_coeffs``, lifter, c0 := log-energy;
    optionally concatenate deltas.  Returns (T, F).
    """
    feat, energy = fbank_features(
        signal, samplerate, winlen, winstep, num_mel_features, nfft, preemph
    )
    log_feat = np.log(feat)
    log_energy = np.log(energy)
    if USE_LOG_MELS:
        features = np.concatenate([log_feat, log_energy[:, None]], axis=1)
    else:
        cepstra = dct(log_feat, type=2, axis=1, norm="ortho")
        cepstra = cepstra[:, :num_cepstral_coeffs]
        cepstra = lifter(cepstra, ceplifter)
        if num_cepstral_coeffs > 0:
            cepstra[:, 0] = log_energy
        features = cepstra
    if USE_MFCC_DELTAS:
        features = np.concatenate(
            [features, delta_features(features, N=2)], axis=1
        )
    return features


def num_mfcc_features(
    num_mel_features: int = 26,
    num_cepstral_coeffs: int = 13,
    USE_LOG_MELS: bool = False,
    USE_MFCC_DELTAS: bool = False,
) -> int:
    """Feature-count accounting (reference data_generators.py:163-171)."""
    base = (num_mel_features + 1) if USE_LOG_MELS else num_cepstral_coeffs
    return base * (2 if USE_MFCC_DELTAS else 1)


def empty_mfcc_features(
    num_features: int, num_frames: int = 0
) -> np.ndarray:
    """Zero-length fallback when a trial has no audio (reference
    data_generators.py:334-341)."""
    return np.zeros((num_frames, num_features))
