"""STFT, linear and mel spectrograms (port of ``vits_tpu/ops/stft.py``).

The same semantics as the JAX version: reflect-pad by (n_fft - hop) / 2,
center=False frames, periodic Hann window folded into a real-DFT basis, one
f32 matmul, magnitude sqrt(re^2 + im^2 + 1e-6); the mel projection uses a
librosa-style Slaney filterbank and log(clamp(x, 1e-5)) compression. The
bases are built in f64 by numpy and cast to f32, as the JAX version builds
them. All spectral math is f32 whatever the compute policy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F


# -- mel filterbank (librosa-compatible: htk=False, norm='slaney') ------------


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_mels = min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_mels, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, 1+n_fft//2]
    (librosa.filters.mel with htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# -- STFT via framed matmul -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis [n_fft, 2*(1+n_fft//2)] (cos | -sin)."""
    n_freqs = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:  # torch zero-pads the window symmetrically
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (basis * window[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(make, device: torch.device, *args) -> torch.Tensor:
    """A numpy constant ``make(*args)`` as a tensor on ``device``, copied once."""
    return torch.from_numpy(make(*args)).to(device)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_fft] overlapping frames (center=False)."""
    return y.unfold(-1, n_fft, hop)


def spectrogram(
    y: torch.Tensor, n_fft: int, hop_size: int, win_size: int, *, pad: bool = True
) -> torch.Tensor:
    """Waveform [B, T] in [-1, 1] -> [B, n_frames, 1+n_fft//2] magnitudes."""
    y = y.to(torch.float32)
    if pad:
        p = (n_fft - hop_size) // 2
        y = F.pad(y[:, None], (p, p), mode="reflect")[:, 0]
    frames = frame_signal(y, n_fft, hop_size)
    spec = torch.matmul(frames, _on_device(_dft_basis, y.device, n_fft, win_size))
    n_freqs = 1 + n_fft // 2
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    return torch.sqrt(re * re + im * im + 1e-6)


def spec_to_mel(
    spec: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, fmin: float,
    fmax: float | None,
) -> torch.Tensor:
    """Linear spectrogram [B, T, F] -> log-mel [B, T, n_mels], f32."""
    basis = _on_device(mel_filterbank, spec.device, sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = torch.matmul(spec.to(torch.float32), basis.T)
    return spectral_normalize(mel)


def spectral_normalize(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """Dynamic-range compression log(clamp(x, clip))."""
    return torch.log(torch.clamp(x, min=clip_val))


def spectral_de_normalize(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``spectral_normalize``."""
    return torch.exp(x)


def mel_spectrogram(
    y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, hop_size: int,
    win_size: int, fmin: float, fmax: float | None,
) -> torch.Tensor:
    """Waveform [B, T] -> log-mel [B, T', n_mels]."""
    spec = spectrogram(y, n_fft, hop_size, win_size)
    return spec_to_mel(spec, n_fft, num_mels, sampling_rate, fmin, fmax)
