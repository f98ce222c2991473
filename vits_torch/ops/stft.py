"""STFT, linear and mel spectrograms (port of ``vits_tpu/ops/stft.py``).

The same semantics as the JAX version: reflect-pad by (n_fft - hop) / 2,
center=False frames, periodic Hann window folded into a real-DFT basis, one
matmul, magnitude sqrt(re^2 + im^2 + 1e-6); the mel projection uses a
librosa-style Slaney filterbank and log(clamp(x, 1e-5)) compression. The
bases are built in f64 by numpy and cast to f32, as the JAX version builds
them. All spectral math is f32 whatever the compute policy.

The two matmuls (the DFT and the filterbank) take their f32 operands to f64,
sum there and round the result to f32 (``_f32_product``): the f32 inputs'
exact products, whatever reduced f32 matmul precision is set globally. With
TF32 matmuls on a card, or ``torch.set_float32_matmul_precision("medium")``
on a CPU with bf16 matrix units, an f32 matmul would round its operands and
move the log-mel of a quiet bin by 1e-3 to 1e-2.
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
    """A numpy f32 constant ``make(*args)`` as an f64 tensor on ``device``,
    copied once; a normal tensor even when the first call comes from
    ``torch.inference_mode`` (serving), so training can use it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device, torch.float64)


def _f32_product(a: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``a @ basis`` for an f32 ``a`` and an f64 copy of an f32 ``basis``:
    products exact and sums in f64, rounded once to f32."""
    return torch.matmul(a.to(torch.float64), basis).to(torch.float32)


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
    spec = _f32_product(frames, _on_device(_dft_basis, y.device, n_fft, win_size))
    n_freqs = 1 + n_fft // 2
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    return torch.sqrt(re * re + im * im + 1e-6)


def spec_to_mel(
    spec: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int, fmin: float,
    fmax: float | None,
) -> torch.Tensor:
    """Linear spectrogram [B, T, F] -> log-mel [B, T, n_mels], f32."""
    basis = _on_device(mel_filterbank, spec.device, sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = _f32_product(spec.to(torch.float32), basis.T)
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


# -- inverse STFT: a real inverse-DFT basis product and overlap-add ------------


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    """Periodic Hann window of n samples (``torch.hann_window(n)``), f64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=None)
def _idft_basis(n_fft: int) -> np.ndarray:
    """Windowed real inverse-DFT basis [2 * (1 + n_fft // 2), n_fft], f32:
    row k takes Re X_k, row 1 + n_fft // 2 + k takes Im X_k, to a frame's
    samples times the window. A onesided inverse, as ``torch.istft``'s
    ``irfft``: the other bins are the conjugates (weight 2, the DC and
    Nyquist bins 1) and the imaginary parts of the DC and Nyquist bins are
    dropped."""
    n_freqs = 1 + n_fft // 2
    k = np.arange(n_freqs)[:, None]
    ang = 2.0 * np.pi * k * np.arange(n_fft)[None, :] / n_fft
    edge = (k == 0) | (2 * k == n_fft)
    weight = np.where(edge, 1.0, 2.0) / n_fft
    basis = np.concatenate([weight * np.cos(ang), np.where(edge, 0.0, -weight * np.sin(ang))])
    return (basis * _hann(n_fft)[None, :]).astype(np.float32)


class InverseSTFT(torch.nn.Module):
    """``torch.istft(mag * exp(1j * phase), n_fft, hop, n_fft,
    torch.hann_window(n_fft), center=True)`` from device work alone, so that
    a CUDA graph can capture it: ATen's ``istft`` reads the window envelope's
    smallest value on the host, a read a capture refuses.

    Each frame's samples are one f32 matrix product with the windowed
    inverse-DFT basis; the frames are overlap-added (``n_fft`` a multiple of
    ``hop``: ``n_fft // hop`` shifted adds), divided by the overlap-added
    squared window (the envelope; it depends on the number of frames alone,
    and is made on the device from the window in the same call) and trimmed
    by ``n_fft // 2`` at both ends. The basis and the squared window are
    non-persistent buffers: they follow ``.to(device)`` and stay out of the
    state dict."""

    def __init__(self, n_fft: int, hop: int):
        super().__init__()
        if n_fft % hop != 0:
            raise ValueError(f"InverseSTFT: n_fft {n_fft} is not a multiple of hop {hop}")
        self.n_fft, self.hop = n_fft, hop
        self.register_buffer("basis", torch.from_numpy(_idft_basis(n_fft)), persistent=False)
        win_sq = (_hann(n_fft) ** 2).astype(np.float32)
        self.register_buffer("window_sq", torch.from_numpy(win_sq), persistent=False)

    def _overlap_add(self, frames: torch.Tensor) -> torch.Tensor:
        """[..., F, n_fft] -> [..., hop * (F - 1) + n_fft]: frame f added at
        sample hop * f."""
        r = self.n_fft // self.hop
        *lead, f, _ = frames.shape
        parts = frames.unflatten(-1, (r, self.hop))  # [..., F, r, hop]
        out = frames.new_zeros((*lead, f + r - 1, self.hop))
        for j in range(r):
            out[..., j: j + f, :] += parts[..., j, :]
        return out.flatten(-2)

    def forward(self, mag: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """mag, phase [..., 1 + n_fft // 2, F] -> audio [..., hop * (F - 1)], f32."""
        mag, phase = mag.float(), phase.float()
        spec = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-2)
        frames = torch.matmul(spec.transpose(-1, -2), self.basis)  # [..., F, n_fft]
        y = self._overlap_add(frames)
        env = self._overlap_add(self.window_sq.expand(frames.shape[-2], -1))
        trim = self.n_fft // 2
        end = y.shape[-1] - trim
        return y[..., trim:end] / env[trim:end]
