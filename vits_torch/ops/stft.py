"""Framing and the linear magnitude spectrogram (port of the two functions of
``vits_tpu/ops/stft.py`` that the generator forward needs: ``frame_signal``
and ``spectrogram``).

The same semantics as the JAX version: reflect-pad by (n_fft - hop) / 2,
center=False frames, periodic Hann window folded into a real-DFT basis, one
f32 matmul, magnitude sqrt(re^2 + im^2 + 1e-6). The basis is built in f64 by
numpy and cast to f32, as the JAX version builds it. Mel and the rest of
``stft.py`` come with the GAN side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F


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
    basis = torch.from_numpy(_dft_basis(n_fft, win_size)).to(y.device)
    spec = torch.matmul(frames, basis)
    n_freqs = 1 + n_fft // 2
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    return torch.sqrt(re * re + im * im + 1e-6)
