"""Yingram, the YIN-based pitch feature (port of ``vits_tpu/ops/yin.py``).

The cumulative mean-normalized difference function (cMNDF) of YIN, sampled
at midi-note lags with linear interpolation; the difference function comes
from an rFFT autocorrelation padded to the same "nice" size as the JAX
version. Everything is f32 on the device; ``yingram_numpy`` is the f64 host
version, kept as the oracle. Output channels-last [B, T', M].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vits_torch.ops.stft import frame_signal


def midi_to_lag(m: int, sr: int, octave_range: float = 12) -> float:
    """midi -> lag in samples: sr / (440 * 2^((m-69)/octave_range))."""
    f = 440.0 * math.pow(2, (m - 69) / octave_range)
    return sr / f


def _nice_fft_size(size: int) -> int:
    """Smallest `nice` FFT size >= size."""
    p2 = (size // 32).bit_length()
    nice_numbers = (16, 18, 20, 24, 25, 27, 30, 32)
    return min(x * 2**p2 for x in nice_numbers if x * 2**p2 >= size)


def difference_function(frames: torch.Tensor, tau_max: int) -> torch.Tensor:
    """YIN d(tau), tau in [0, tau_max): frames [N, W] -> [N, tau_max]."""
    w = frames.shape[-1]
    tau_max = min(tau_max, w)
    x = frames.to(torch.float32)
    energy = torch.nn.functional.pad(torch.cumsum(x * x, dim=-1), (1, 0))  # [N, W+1]
    size_pad = _nice_fft_size(w + tau_max)
    fc = torch.fft.rfft(x, n=size_pad, dim=-1)
    acorr = torch.fft.irfft(fc * torch.conj(fc), n=size_pad, dim=-1)[:, :tau_max]
    head = torch.flip(energy[:, w - tau_max + 1 : w + 1], [-1])
    return head + energy[:, w : w + 1] - energy[:, :tau_max] - 2.0 * acorr


def cmndf(dfs: torch.Tensor, tau_max: int, eps: float = 1e-8) -> torch.Tensor:
    """Cumulative mean-normalized difference function."""
    arange = torch.arange(1, tau_max, dtype=dfs.dtype, device=dfs.device)
    cum = torch.cumsum(dfs[:, 1:], dim=-1)
    out = dfs[:, 1:] * arange / (cum + eps)
    return torch.cat([torch.ones_like(dfs[:, :1]), out], dim=-1)


class Yingram:
    """Yingram extractor with precomputed midi-lag tables (W=2048, step 256
    in the models here). A plain object like the JAX version, not a module:
    its tables move to the input's device at each call."""

    def __init__(
        self,
        sr: int = 22050,
        w_step: int = 256,
        w_size: int = 2048,
        tau_max: int = 2048,
        midi_start: int = 5,
        midi_end: int = 85,
        octave_range: int = 12,
    ):
        self.w_step = w_step
        self.w_size = w_size
        self.tau_max = tau_max
        midis = list(range(midi_start, midi_end))
        self.n_midis = len(midis)
        c_ms = np.array([midi_to_lag(m, sr, octave_range) for m in midis])
        self.c_ms = torch.tensor(c_ms, dtype=torch.float32)
        self.c_ms_ceil = torch.tensor(np.ceil(c_ms).astype(np.int64))
        self.c_ms_floor = torch.tensor(np.floor(c_ms).astype(np.int64))

    def yingram_from_cmndf(self, cmndfs: torch.Tensor) -> torch.Tensor:
        """[N, tau_max] -> [N, M]: linear interpolation at the midi lags."""
        dev = cmndfs.device
        ceil_i, floor_i = self.c_ms_ceil.to(dev), self.c_ms_floor.to(dev)
        ceil_v = cmndfs[:, ceil_i]
        floor_v = cmndfs[:, floor_i]
        denom = (ceil_i - floor_i).to(cmndfs.dtype)
        frac = (self.c_ms.to(dev) - floor_i.to(torch.float32)).to(cmndfs.dtype)
        return (ceil_v - floor_v) / denom[None, :] * frac[None, :] + floor_v

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Raw audio [B, T] -> yingram [B, T', M], T' = 1 + (T - W) // step."""
        b = x.shape[0]
        frames = frame_signal(x, self.w_size, self.w_step)
        n_frames = frames.shape[1]
        dfs = difference_function(frames.reshape(b * n_frames, self.w_size), self.tau_max)
        y = self.yingram_from_cmndf(cmndf(dfs, self.tau_max))
        return y.reshape(b, n_frames, self.n_midis)


def yingram_numpy(
    x: np.ndarray,
    sr: int = 22050,
    w_step: int = 256,
    w_size: int = 2048,
    tau_max: int = 2048,
    midi_start: int = 5,
    midi_end: int = 85,
    octave_range: int = 12,
) -> np.ndarray:
    """Float64 host yingram (the oracle). x: [B, T] -> [B, T', M]."""
    x = np.asarray(x, dtype=np.float64)
    b, t = x.shape
    n_frames = 1 + (t - w_size) // w_step
    idx = np.arange(n_frames)[:, None] * w_step + np.arange(w_size)[None, :]
    frames = x[:, idx].reshape(b * n_frames, w_size)

    w = w_size
    tm = min(tau_max, w)
    energy = np.concatenate(
        [np.zeros((frames.shape[0], 1)), np.cumsum(frames * frames, axis=-1)], axis=-1
    )
    size_pad = _nice_fft_size(w + tm)
    fc = np.fft.rfft(frames, n=size_pad, axis=-1)
    acorr = np.fft.irfft(fc * np.conj(fc), n=size_pad, axis=-1)[:, :tm]
    head = energy[:, w - tm + 1 : w + 1][:, ::-1]
    dfs = head + energy[:, w : w + 1] - energy[:, :tm] - 2.0 * acorr

    arange = np.arange(1, tm)
    cum = np.cumsum(dfs[:, 1:], axis=-1)
    c = dfs[:, 1:] * arange / (cum + 1e-8)
    c = np.concatenate([np.ones((dfs.shape[0], 1)), c], axis=-1)

    midis = np.arange(midi_start, midi_end)
    c_ms = sr / (440.0 * 2.0 ** ((midis - 69) / octave_range))
    ceil_i = np.ceil(c_ms).astype(np.int64)
    floor_i = np.floor(c_ms).astype(np.int64)
    y = (c[:, ceil_i] - c[:, floor_i]) / (ceil_i - floor_i)[None, :] * (
        c_ms - floor_i
    )[None, :] + c[:, floor_i]
    return y.reshape(b, n_frames, len(midis))
