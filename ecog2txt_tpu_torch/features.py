"""Raw-voltage → high-gamma analytic-amplitude featurization.

The twin of ``ecog2txt_tpu/features.py``, the front end from the
amplifier to the model's input rate:

    notch (line harmonics) → log-spaced Gaussian band-pass bank over
    the high-gamma range → Hilbert analytic amplitude (FFT method,
    ``scipy.signal.hilbert``'s definition) → band average → z-score →
    anti-aliased decimation to the manifest sampling rate

* The chain runs on the tensors' device: one forward FFT
  (``torch.fft``: cuFFT on the card, pocketfft on the CPU), then one
  masked inverse FFT and magnitude a band, summed; decimation is a
  strided ``F.conv1d`` with the channels as batch, in f64 (so no TF32 on
  the card), rounded to f32.  The masks and taps are numpy constants of
  the static shapes, the JAX package's arrays, with
  ``n_fft = _next_fast_len(T)``.
* Trials are reflect-padded by a margin ``P`` (a whole number of
  decimation hops, below T) so the circular filtering never reaches
  valid samples.
* :class:`StreamingHighGamma` runs the same chain over overlapped
  windows: its buffers stay on the host, in the digitizer's dtype (int16
  stays int16), and each window is uploaded once and featurized on the
  stream's device; emitted frames equal the offline chain to float
  tolerance, lagging it by the margin.

``extract_high_gamma_np`` and :func:`calibrate_high_gamma` take numpy and
a ``device`` that defaults to CUDA, like every entry point of the port;
pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device


@dataclass(frozen=True)
class HighGammaConfig:
    """Static featurization spec.  ``raw_rate`` must be an integer
    multiple of ``out_rate`` (the manifest's ``sampling_rate``); the
    decimation factor is ``raw_rate // out_rate``."""

    raw_rate: float  # input sample rate (Hz)
    out_rate: float  # output feature rate (Hz)
    band: tuple[float, float] = (70.0, 150.0)  # high-gamma range
    num_bands: int = 8  # log-spaced Gaussian sub-bands
    band_sigma_scale: float = 0.10  # Gaussian sigma = scale * center freq
    notch_freqs: tuple[float, ...] = (60.0, 120.0, 180.0)
    notch_sigma: float = 1.5  # Hz, Gaussian band-stop width
    pad_seconds: float = 0.5  # reflect margin (>= the notch's impulse length)
    zscore: str = "trial"  # 'trial' | 'none' (block: see ArrayDataGenerator)
    input_scale: float = 1.0  # volts per int16 LSB when raw is integer

    def __post_init__(self):
        q = self.raw_rate / self.out_rate
        if abs(q - round(q)) > 1e-9 or round(q) < 1:
            raise ValueError(
                f"raw_rate {self.raw_rate} must be an integer multiple of "
                f"out_rate {self.out_rate}"
            )
        if self.band[1] >= self.raw_rate / 2:
            raise ValueError(
                f"band top {self.band[1]} Hz needs raw_rate > {2 * self.band[1]} Hz"
            )
        if self.zscore not in ("trial", "none"):
            raise ValueError(f"zscore must be 'trial' or 'none': {self.zscore}")

    @property
    def decimation(self) -> int:
        return int(round(self.raw_rate / self.out_rate))

    @property
    def pad_samples(self) -> int:
        return int(round(self.pad_seconds * self.raw_rate))

    @property
    def center_freqs(self) -> np.ndarray:
        lo, hi = self.band
        return np.geomspace(lo, hi, self.num_bands)


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n."""
    if n <= 6:
        return n
    best = 1 << (n - 1).bit_length()  # a power of two always qualifies
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            x = f35
            while x < n:
                x *= 2
            best = min(best, x)
            f35 *= 3
        f5 *= 5
    return best


# --------------------------------------------------------------------------
# masks and taps (numpy constants of the static shapes)
# --------------------------------------------------------------------------


def _notch_response(freqs: np.ndarray, cfg: HighGammaConfig) -> np.ndarray:
    """Gaussian band-stop at each line harmonic: prod(1 - e^(-df^2/2s^2))."""
    resp = np.ones_like(freqs)
    for f0 in cfg.notch_freqs:
        resp *= 1.0 - np.exp(-((freqs - f0) ** 2) / (2.0 * cfg.notch_sigma**2))
    return resp


def _band_responses(freqs: np.ndarray, cfg: HighGammaConfig) -> np.ndarray:
    """(num_bands, F) Gaussian magnitude responses, log-spaced centers."""
    cfs = cfg.center_freqs
    sds = cfg.band_sigma_scale * cfs
    return np.exp(-((freqs[None, :] - cfs[:, None]) ** 2) / (2.0 * sds[:, None] ** 2))


def _analytic_band_masks(n_fft: int, cfg: HighGammaConfig) -> np.ndarray:
    """(num_bands, n_fft) complex64 masks: the Gaussian band x the notch x
    the analytic-signal mask (2 on positive frequencies, 1 at DC and
    Nyquist, 0 on negative ones: ``scipy.signal.hilbert``'s h)."""
    freqs = np.fft.fftfreq(n_fft, d=1.0 / cfg.raw_rate)
    mag = _band_responses(np.abs(freqs), cfg) * _notch_response(np.abs(freqs), cfg)
    h = np.zeros(n_fft)
    h[0] = 1.0
    if n_fft % 2 == 0:
        h[n_fft // 2] = 1.0
        h[1: n_fft // 2] = 2.0
    else:
        h[1: (n_fft + 1) // 2] = 2.0
    return (mag * h[None, :]).astype(np.complex64)


def _decimation_taps(q: int) -> np.ndarray:
    """Anti-alias FIR low-pass for decimation by q (scipy.signal.decimate's
    FIR design: 20q+1 Hamming taps, cutoff 1/q of Nyquist)."""
    if q == 1:
        return np.ones(1, np.float32)
    from scipy.signal import firwin

    return firwin(20 * q + 1, 1.0 / q, window="hamming").astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_masks(n_fft: int, cfg: HighGammaConfig, device: torch.device) -> torch.Tensor:
    """(num_bands, n_fft, 1) complex64 masks on ``device``, made once."""
    return torch.from_numpy(_analytic_band_masks(n_fft, cfg)).to(device)[..., None]


@functools.lru_cache(maxsize=16)
def _device_taps(q: int, device: torch.device) -> torch.Tensor:
    """(1, 1, K) flipped f32 taps (correlation → convolution) on
    ``device``, held as f64 for the convolution."""
    taps = _decimation_taps(q)[::-1].astype(np.float64)
    return torch.from_numpy(taps).to(device)[None, None]


# --------------------------------------------------------------------------
# the chain
# --------------------------------------------------------------------------


def band_envelopes(x: torch.Tensor, cfg: HighGammaConfig) -> torch.Tensor:
    """Mean analytic amplitude over the band bank, at the raw rate.
    ``x``: (T, C) raw voltages, margin-padded by the caller.  Returns
    (T, C) f32."""
    T = x.shape[0]
    n_fft = _next_fast_len(T)
    masks = _device_masks(n_fft, cfg, x.device)
    X = torch.fft.fft(x.float(), n=n_fft, dim=0)  # (n_fft, C)
    acc = torch.zeros((T, x.shape[1]), dtype=torch.float32, device=x.device)
    for b in range(cfg.num_bands):
        acc = acc + torch.fft.ifft(X * masks[b], dim=0)[:T].abs()
    return acc / cfg.num_bands


def decimate_envelope(hg: torch.Tensor, cfg: HighGammaConfig) -> torch.Tensor:
    """Anti-aliased decimation by q as a strided convolution: output frame
    i is ``np.convolve(hg[:, c], taps, 'same')[i * q]`` (symmetric taps).
    (T, C) → (T // q, C)."""
    q = cfg.decimation
    if q == 1:
        return hg
    taps = _device_taps(q, hg.device)
    K = taps.shape[-1]  # odd
    T = hg.shape[0]
    # in f64: cuDNN may run an f32 convolution in TF32, never an f64 one
    out = F.conv1d(hg.T[:, None, :].double(), taps, stride=q, padding=K // 2)  # (C, 1, .)
    return out[:, 0, : T // q].T.float()


def _to_float(raw: torch.Tensor, cfg: HighGammaConfig) -> torch.Tensor:
    if not raw.is_floating_point():
        return raw.float() * cfg.input_scale
    return raw.float()


def extract_high_gamma(raw: torch.Tensor, cfg: HighGammaConfig) -> torch.Tensor:
    """The chain on one trial, on ``raw``'s device: (T_raw, C) raw
    voltages (float, or integer scaled by ``cfg.input_scale``) →
    (T_raw // q, C) f32 features.  The margin ``P`` is a whole number of
    decimation hops, so the margin's envelope gives the decimation FIR
    context instead of a zero-pad transient, and below T, so the
    reflection exists."""
    raw = _to_float(raw, cfg)
    T = raw.shape[0]
    q = cfg.decimation
    P = min(-(-cfg.pad_samples // q) * q, ((T - 1) // q) * q)
    # reflect padding over time on a (1, C, T) view
    padded = F.pad(raw.T[None], (P, P), mode="reflect")[0].T if P else raw
    hg = band_envelopes(padded, cfg)
    feats = decimate_envelope(hg, cfg)[P // q: P // q + T // q]
    if cfg.zscore == "trial":
        mu = feats.mean(dim=0, keepdim=True)
        sd = feats.std(dim=0, keepdim=True, correction=0)
        feats = (feats - mu) / torch.clamp(sd, min=1e-6)
    return feats


def extract_high_gamma_np(raw: np.ndarray, cfg: HighGammaConfig, device="cuda") -> np.ndarray:
    """Numpy front door of the offline chain: (T_raw, C) raw voltages
    (float or integer; an integer array is uploaded as it is and scaled on
    the device) → numpy (T_raw // q, C) f32 features, computed on
    ``device``."""
    dev = resolve_device(device)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(raw)).to(dev)
        return extract_high_gamma(x, cfg).cpu().numpy()


def calibrate_high_gamma(raws: Sequence[np.ndarray], cfg: HighGammaConfig,
                         device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Per-channel (mean, std) of the un-normalised chain output over
    calibration recordings: the ``stats`` of :class:`StreamingHighGamma`
    (per-trial statistics do not exist mid-stream)."""
    cfg_raw = replace(cfg, zscore="none")
    n, s, ss = 0, None, None
    for raw in raws:
        f = extract_high_gamma_np(np.asarray(raw), cfg_raw, device)
        if s is None:
            s = f.sum(0, dtype=np.float64)
            ss = (f.astype(np.float64) ** 2).sum(0)
        else:
            s += f.sum(0, dtype=np.float64)
            ss += (f.astype(np.float64) ** 2).sum(0)
        n += len(f)
    if not n:
        raise ValueError("calibrate_high_gamma needs at least one frame")
    mu = s / n
    var = np.maximum(ss / n - mu**2, 0.0)
    return mu.astype(np.float32), np.sqrt(var).astype(np.float32)


# --------------------------------------------------------------------------
# streaming (overlap-save windows over the same chain)
# --------------------------------------------------------------------------


class StreamingHighGamma:
    """Streaming front end: push raw chunks of any length, receive the
    feature frames of :func:`extract_high_gamma` (zscore='none') on the
    whole signal, to float tolerance.

    Each window is ``window`` raw samples with a ``margin`` on each side
    (past samples are real history; the first window reflects, as the
    offline pad does); emission lags the stream by the margin.  The
    buffer stays on the host in the input's dtype (an int16 digitizer's
    samples stay int16 until the device converts them), each window goes
    to ``device`` once.  ``stats``: optional (mean, std) per channel from
    :func:`calibrate_high_gamma`, applied to the emitted frames."""

    def __init__(
        self,
        cfg: HighGammaConfig,
        num_channels: int,
        window_seconds: float = 2.0,
        stats: tuple[np.ndarray, np.ndarray] | None = None,
        device="cuda",
    ):
        if cfg.zscore != "none":
            raise ValueError(
                "streaming featurization needs zscore='none' (pass calibration "
                "stats instead: per-trial stats do not exist mid-stream)"
            )
        self.cfg = cfg
        self.C = int(num_channels)
        self.device = resolve_device(device)
        q = cfg.decimation
        W = int(round(window_seconds * cfg.raw_rate))
        self.window = max(q, (W // q) * q)  # a multiple of q
        self.margin = -(-cfg.pad_samples // q) * q  # a multiple of q
        self.stats = None
        if stats is not None:
            mu, sd = stats
            self.stats = (
                np.asarray(mu, np.float32).reshape(1, -1),
                np.maximum(np.asarray(sd, np.float32).reshape(1, -1), 1e-6),
            )
        if self.window < self.margin:
            raise ValueError(
                f"window ({self.window} samples) must be >= the margin "
                f"({self.margin}); raise window_seconds or lower pad_seconds"
            )
        # [margin history (already emitted)] + [pending]; before the first
        # emission there is no history (a reflection stands in for it)
        self._buf: np.ndarray | None = None
        self._emitted_any = False

    def _host(self, chunk: np.ndarray) -> np.ndarray:
        """A chunk in the buffer's dtype: int16 stays int16 while every
        chunk so far was int16, anything else is f32 (integers scaled)."""
        chunk = np.asarray(chunk).reshape(-1, self.C)
        keep_int = chunk.dtype == np.int16 and (self._buf is None or self._buf.dtype == np.int16)
        if keep_int:
            return chunk
        if self._buf is not None and self._buf.dtype == np.int16:
            self._buf = self._buf.astype(np.float32) * np.float32(self.cfg.input_scale)
        if np.issubdtype(chunk.dtype, np.integer):
            return chunk.astype(np.float32) * np.float32(self.cfg.input_scale)
        return chunk.astype(np.float32)

    def _chain(self, seg: np.ndarray) -> torch.Tensor:
        """Upload one segment and run the band chain and the decimation
        over all of it (the margins give the FIR context)."""
        x = _to_float(torch.from_numpy(np.ascontiguousarray(seg)).to(self.device), self.cfg)
        return decimate_envelope(band_envelopes(x, self.cfg), self.cfg)

    def _finish(self, frames: torch.Tensor) -> np.ndarray:
        out = frames.cpu().numpy()
        if self.stats is not None:
            out = (out - self.stats[0]) / self.stats[1]
        return out

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.C), np.float32)

    @torch.inference_mode()
    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Append raw samples; return the newly available feature frames
        ((0, C) until a window has filled)."""
        chunk = self._host(chunk)
        self._buf = chunk if self._buf is None else np.concatenate([self._buf, chunk])
        outs = []
        M, W, q = self.margin, self.window, self.cfg.decimation
        while True:
            if not self._emitted_any:
                # the left margin is a reflection (offline parity): needs
                # the window and the right margin of real samples
                if len(self._buf) < W + M:
                    break
                seg = np.concatenate([self._buf[1: M + 1][::-1], self._buf[: W + M]])
                self._buf = self._buf[W - M:]  # the last M samples stay as history
                self._emitted_any = True
            else:
                if len(self._buf) < M + W + M:
                    break
                seg = self._buf[: M + W + M]
                self._buf = self._buf[W:]
            outs.append(self._finish(self._chain(seg)[M // q: (M + W) // q]))
        return np.concatenate(outs) if outs else self._empty()

    @torch.inference_mode()
    def flush(self, reset: bool = True) -> np.ndarray:
        """Featurize the remaining tail with a reflected right margin
        (offline parity); trailing samples short of one decimation hop are
        dropped.  Resets the stream unless ``reset=False`` (a speculative
        peek: serving decodes mid-utterance without disturbing the live
        stream)."""
        M, q = self.margin, self.cfg.decimation
        buf = self._buf if self._buf is not None else self._empty()
        start = M if self._emitted_any else 0
        tail_q = ((len(buf) - start) // q) * q
        out = self._empty()
        if tail_q > 0:
            seg = buf
            if not self._emitted_any:
                # a short stream may not fill the margin: shrink it (a
                # multiple of q), as the offline margin is clamped
                M = min(M, ((len(seg) - 1) // q) * q)
                seg = np.concatenate([seg[1: M + 1][::-1], seg])
            mr = min(len(seg) - 1, self.margin)
            seg = np.concatenate([seg, seg[-2: -mr - 2: -1]])  # right reflection
            out = self._finish(self._chain(seg)[M // q: M // q + tail_q // q])
        if reset:
            self._buf = None
            self._emitted_any = False
        return out


# --------------------------------------------------------------------------
# synthetic raw voltage (tests, demos, the chip smoke)
# --------------------------------------------------------------------------


def synthesize_raw_from_envelope(
    envelope: np.ndarray,
    cfg: HighGammaConfig,
    rng: np.random.Generator,
    line_amp: float = 0.5,
    background: float = 0.05,
) -> np.ndarray:
    """Turn a (T_out, C) nonnegative envelope at the feature rate into
    (T_out * q, C) raw voltage whose high-gamma analytic amplitude tracks
    it::

        raw = upsample(envelope) * bandnoise(70-150 Hz)
              + line_amp * (60 Hz + harmonics) + background * noise

    so that :func:`extract_high_gamma` recovers ``envelope`` up to the
    bank's gain."""
    q = cfg.decimation
    T_out, C = envelope.shape
    T = T_out * q
    t = np.arange(T) / cfg.raw_rate
    env = np.repeat(envelope, q, axis=0)  # zero-order hold
    # band-limited carrier: white noise filtered to the high-gamma band
    white = rng.standard_normal((T, C)).astype(np.float32)
    X = np.fft.rfft(white, axis=0)
    freqs = np.fft.rfftfreq(T, d=1.0 / cfg.raw_rate)
    lo, hi = cfg.band
    mask = ((freqs >= lo) & (freqs <= hi)).astype(np.float32)
    carrier = np.fft.irfft(X * mask[:, None], n=T, axis=0)
    # unit analytic amplitude, so the envelope's scale carries through
    carrier /= np.maximum(np.std(carrier, axis=0, keepdims=True), 1e-9)
    carrier *= np.sqrt(2.0) / 2.0
    line = sum(
        np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        for f0 in cfg.notch_freqs
        if f0 < cfg.raw_rate / 2
    )
    raw = (
        env * carrier
        + line_amp * np.asarray(line)[:, None]
        + background * rng.standard_normal((T, C))
    )
    return raw.astype(np.float32)
