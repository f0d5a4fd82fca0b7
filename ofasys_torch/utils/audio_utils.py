"""Audio feature extraction, numpy on the host (counterpart of
ofasys_tpu/utils/audio_utils.py, the same operations in the same order, so
the features are bit for bit the same).

A kaldi-compatible log-mel pipeline: dither-free preemphasis, povey
window, FFT power spectrum, mel filterbank, natural log. Also WAV loading
through the stdlib, CMVN, SpecAugment, and Griffin-Lim inversion for the
TTS decode.
"""

from __future__ import annotations

import io
import wave
from typing import Optional, Tuple

import numpy as np


def load_wav(source) -> Tuple[np.ndarray, int]:
    """path / bytes -> (float32 mono waveform in [-1, 1], sample_rate)."""
    if isinstance(source, tuple):
        return np.asarray(source[0], np.float32), int(source[1])
    if isinstance(source, np.ndarray):
        return source.astype(np.float32), 16000
    data = source
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            x = (x - 128.0) / 128.0
        else:
            x = x / float(np.iinfo(dtype).max)
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(axis=1)
    return x, sr


def mel_filterbank(num_mels: int, n_fft: int, sample_rate: int,
                   low_freq: float = 20.0, high_freq: Optional[float] = None) -> np.ndarray:
    """(num_mels, n_fft//2+1) triangular mel filters (HTK mel scale)."""
    high_freq = high_freq or sample_rate / 2.0
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (np.exp(m / 1127.0) - 1.0)
    pts = imel(np.linspace(mel(low_freq), mel(high_freq), num_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sample_rate).astype(int)
    fb = np.zeros((num_mels, n_fft // 2 + 1), np.float32)
    for i in range(num_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        for j in range(l, c):
            if c > l:
                fb[i, j] = (j - l) / (c - l)
        for j in range(c, r):
            if r > c:
                fb[i, j] = (r - j) / (r - c)
    return fb


def logmel_fbank(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    num_mels: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    preemphasis: float = 0.97,
) -> np.ndarray:
    """(T, num_mels) kaldi-style log-mel filterbank features."""
    frame_len = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (frame_len - 1).bit_length()
    if len(waveform) < frame_len:
        waveform = np.pad(waveform, (0, frame_len - len(waveform)))
    n_frames = 1 + (len(waveform) - frame_len) // shift
    idx = np.arange(frame_len)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = waveform[idx].copy()
    # per-frame DC removal then preemphasis (kaldi order)
    frames -= frames.mean(axis=1, keepdims=True)
    frames[:, 1:] -= preemphasis * frames[:, :-1]
    frames[:, 0] *= 1.0 - preemphasis
    # povey window = hann ** 0.85
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len) / (frame_len - 1))) ** 0.85
    frames *= window
    spec = np.abs(np.fft.rfft(frames, n=n_fft)) ** 2
    fb = mel_filterbank(num_mels, n_fft, sample_rate)
    mels = spec @ fb.T
    return np.log(np.maximum(mels, 1e-10)).astype(np.float32)


def apply_cmvn(feats: np.ndarray, stats: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
    """Mean/variance normalization; per-utterance when no global stats."""
    if stats is not None:
        mean, std = stats
    else:
        mean = feats.mean(axis=0)
        std = np.maximum(feats.std(axis=0), 1e-8)
    return (feats - mean) / std


def spec_augment(
    feats: np.ndarray,
    rng: np.random.Generator,
    freq_mask_n: int = 2,
    freq_mask_f: int = 27,
    time_mask_n: int = 2,
    time_mask_t: int = 100,
    time_mask_p: float = 1.0,
) -> np.ndarray:
    """SpecAugment (reference utils/audio_feature_transforms/specaugment.py)."""
    out = feats.copy()
    T, F = out.shape
    for _ in range(freq_mask_n):
        f = int(rng.integers(0, min(freq_mask_f, F) + 1))
        f0 = int(rng.integers(0, F - f + 1)) if F > f else 0
        out[:, f0:f0 + f] = 0.0
    max_t = min(time_mask_t, int(T * time_mask_p))
    for _ in range(time_mask_n):
        t = int(rng.integers(0, max_t + 1)) if max_t > 0 else 0
        t0 = int(rng.integers(0, T - t + 1)) if T > t else 0
        out[t0:t0 + t, :] = 0.0
    return out


def griffin_lim(
    log_mel: np.ndarray,
    sample_rate: int = 16000,
    num_mels: int = 80,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    n_iter: int = 32,
) -> np.ndarray:
    """Approximate waveform inversion of log-mel features
    (reference GriffinLimVocoder, module/vocoder.py:52-152)."""
    frame_len = int(sample_rate * frame_length_ms / 1000)
    shift = int(sample_rate * frame_shift_ms / 1000)
    n_fft = 1 << (frame_len - 1).bit_length()
    fb = mel_filterbank(num_mels, n_fft, sample_rate)
    # pseudo-inverse mel -> linear power spectrum
    inv = np.linalg.pinv(fb)
    power = np.maximum(np.exp(log_mel) @ inv.T, 1e-10)
    mag = np.sqrt(power)
    T = mag.shape[0]
    rng = np.random.default_rng(0)
    angles = np.exp(2j * np.pi * rng.random(mag.shape))
    window = np.hanning(frame_len)

    def istft(S):
        frames = np.fft.irfft(S, n=n_fft)[:, :frame_len] * window
        x = np.zeros(shift * (T - 1) + frame_len)
        wsum = np.zeros_like(x)
        for t in range(T):
            x[t * shift:t * shift + frame_len] += frames[t]
            wsum[t * shift:t * shift + frame_len] += window ** 2
        return x / np.maximum(wsum, 1e-8)

    def stft(x):
        idx = np.arange(frame_len)[None, :] + shift * np.arange(T)[:, None]
        xp = np.pad(x, (0, max(0, idx.max() + 1 - len(x))))
        return np.fft.rfft(xp[idx] * window, n=n_fft)

    for _ in range(n_iter):
        x = istft(mag * angles)
        S = stft(x)
        angles = S / np.maximum(np.abs(S), 1e-8)
    x = istft(mag * angles)
    return (x / max(np.abs(x).max(), 1e-8)).astype(np.float32)
