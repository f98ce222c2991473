"""PhaseAug: the differentiable phase-rotation augmentation of the GAN step
(port of ``vits_tpu/ops/phaseaug.py``; Lee et al., ICASSP 2023, with the
``phaseaug`` package's defaults).

  1. a Gaussian phase per STFT bin, phi_raw[k] ~ N(0, 6), over 513 bins;
  2. low-passed along frequency by a Kaiser-windowed sinc (cutoff 0.05,
     transition half-width 0.012, 128 taps, zero padding);
  3. plus a ramp delta * pi * k / K, delta ~ U(-2, 2); the DC bin stays real;
  4. every frame of a centred reflect-padded STFT (Hann, 1024, hop 256) is
     rotated by exp(i * phi), then inverted with the w^2 overlap-add
     normalisation (``apply_phi_stft``, the default, through
     ``torch.fft.rfft`` / ``irfft``).

Real and generated audio get the same rotation (``phaseaug_sync``). Layouts
as in the JAX version: signals ``[B, T]`` or ``[B, T, 1]``, phi ``[B, 513]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

NFFT = 1024
HOP = 256
VAR = 6.0
DELTA_MAX = 2.0
CUTOFF = 0.05
HALF_WIDTH = 0.012
KERNEL_SIZE = 128


def _lowpass_kernel(
    kernel_size: int = KERNEL_SIZE, cutoff: float = CUTOFF, half_width: float = HALF_WIDTH
) -> np.ndarray:
    """Kaiser-windowed ideal low-pass at ``cutoff`` with transition
    ``half_width``, normalised to unit sum (the frequency-axis smoother)."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * np.pi * delta_f + 7.95  # kaiser attenuation
    beta = 0.1102 * (a - 8.7) if a > 50 else (
        0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21) if a >= 21 else 0.0
    )
    t = np.arange(-half, half) + 0.5 if even else np.arange(-half, half + 1)
    window = np.kaiser(len(t), beta)
    k = window * 2 * cutoff * np.sinc(2 * cutoff * t)
    return (k / k.sum()).astype(np.float32)


def phi_from_noise(phi_raw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Steps 2-3 on given draws: phi_raw [B, K] ~ N(0, 1), u [B, 1] ~ U(0, 1)
    -> phi [B, K]."""
    b, n_bins = phi_raw.shape
    kernel = torch.from_numpy(_lowpass_kernel()).to(phi_raw.device)
    pad = kernel.shape[0] // 2
    phi_pad = F.pad(phi_raw * np.sqrt(VAR), (pad, pad - 1 + kernel.shape[0] % 2))
    # a convolution (kernel flipped), "valid" over the zero-padded row
    phi_smooth = F.conv1d(phi_pad[:, None], kernel.flip(0)[None, None])[:, 0]
    delta = (u * 2.0 - 1.0) * DELTA_MAX
    ramp = torch.linspace(0.0, 1.0, n_bins, device=phi_raw.device)[None, :]
    phi = phi_smooth + delta * np.pi * ramp
    phi[:, 0] = 0.0  # DC stays real
    return phi


def sample_phi(
    batch: int, generator: torch.Generator | None = None, device=None,
    n_bins: int = NFFT // 2 + 1,
) -> torch.Tensor:
    """The per-bin rotation phi [batch, n_bins] (steps 1-3), drawn from
    ``generator``."""
    phi_raw = torch.randn((batch, n_bins), generator=generator, device=device)
    u = torch.rand((batch, 1), generator=generator, device=device)
    return phi_from_noise(phi_raw, u)


@functools.lru_cache(maxsize=4)
def _window_and_envelope(t: int) -> tuple[np.ndarray, np.ndarray]:
    """Periodic Hann window and the w^2 overlap-add envelope over the padded
    length (torch.istft's denominator), cropped to [pad : pad + t]."""
    w = np.hanning(NFFT + 1)[:-1].astype(np.float32)
    pad = NFFT // 2
    n_frames = (t + 2 * pad - NFFT) // HOP + 1
    env = np.zeros(t + 2 * pad, np.float32)
    for i in range(n_frames):
        env[i * HOP : i * HOP + NFFT] += w * w
    return w, env[pad : pad + t].copy()


@functools.lru_cache(maxsize=1)
def _rotation_bases() -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases (cos | -sin) [NFFT, 2K] and its Hermitian inverse
    [2K, NFFT] (weights 1/N at DC and Nyquist, 2/N elsewhere)."""
    k = NFFT // 2 + 1
    n = np.arange(NFFT)[:, None]
    ks = np.arange(k)[None, :]
    ang = 2.0 * np.pi * n * ks / NFFT
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    wk = np.full(k, 2.0 / NFFT)
    wk[0] = wk[-1] = 1.0 / NFFT
    inv = np.concatenate([(np.cos(ang) * wk).T, (-np.sin(ang) * wk).T], axis=0)
    return fwd.astype(np.float32), inv.astype(np.float32)


def _rotate_frames_matmul(frames: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Per-frame rotation by exp(i * phi[b]) as two real matmuls, [B, F, NFFT]
    -> [B, F, NFFT]: the independent reference for the FFT path (tests)."""
    fwd, inv = (torch.from_numpy(a).to(frames.device) for a in _rotation_bases())
    k = NFFT // 2 + 1
    spec = torch.matmul(frames, fwd)
    x_re, x_im = spec[..., :k], spec[..., k:]
    c, s = torch.cos(phi)[:, None, :], torch.sin(phi)[:, None, :]
    rot = torch.cat([x_re * c - x_im * s, x_re * s + x_im * c], dim=-1)
    return torch.matmul(rot, inv)


def apply_phi_stft(x: torch.Tensor, phi: torch.Tensor, use_fft: bool = True) -> torch.Tensor:
    """The package's exact pipeline on [B, T] (f32): centred reflect-pad
    STFT, rotate every frame by exp(i * phi[b]), iSTFT with the w^2
    overlap-add normalisation, crop to T. ``use_fft=False`` rotates by the
    DFT matmuls (tests only)."""
    b, t = x.shape
    if t % HOP:
        raise ValueError(f"apply_phi_stft: length {t} is not a multiple of {HOP}")
    w_np, env_np = _window_and_envelope(t)
    w = torch.from_numpy(w_np).to(x.device)
    pad = NFFT // 2
    xp = F.pad(x.to(torch.float32)[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, NFFT, HOP) * w  # [B, F, NFFT]
    if use_fft:
        spec = torch.fft.rfft(frames, dim=-1) * torch.polar(torch.ones_like(phi), phi)[:, None]
        out = torch.fft.irfft(spec, n=NFFT, dim=-1)
    else:
        out = _rotate_frames_matmul(frames, phi)
    out = (out * w).transpose(1, 2)  # [B, NFFT, F]
    total = t + 2 * pad
    y = F.fold(out, (1, total), (1, NFFT), stride=(1, HOP))[:, 0, 0]  # overlap-add
    return y[:, pad : pad + t] / torch.from_numpy(env_np).to(x.device)


def apply_allpass(x: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The LTI all-pass approximation on [B, T]: phi interpolated linearly
    onto the T//2+1 grid of one length-T rfft (~8% waveform RMS from the
    exact path)."""
    b, t = x.shape
    n_freq = t // 2 + 1
    phi_t = F.interpolate(phi[:, None], size=n_freq, mode="linear", align_corners=True)[:, 0]
    if t % 2 == 0:
        phi_t = torch.cat([phi_t[:, :-1], torch.zeros_like(phi_t[:, -1:])], dim=1)  # Nyquist real
    spec = torch.fft.rfft(x.to(torch.float32), dim=1)
    return torch.fft.irfft(spec * torch.polar(torch.ones_like(phi_t), phi_t), n=t, dim=1)


def phaseaug_sync(
    y: torch.Tensor, y_hat: torch.Tensor, generator: torch.Generator | None = None,
    phi: torch.Tensor | None = None, exact: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One random rotation per row applied to both y and y_hat [B, T, 1];
    phi [B, 513] given, or drawn from ``generator``. ``exact=False`` takes
    the all-pass approximation. Outputs keep each input's dtype."""
    b = y.shape[0]
    if phi is None:
        phi = sample_phi(b, generator, device=y.device)
    apply = apply_phi_stft if exact else apply_allpass
    xy = torch.cat([y[..., 0], y_hat[..., 0]], dim=0)
    out = apply(xy, torch.cat([phi, phi], dim=0))
    return out[:b].to(y.dtype)[..., None], out[b:].to(y_hat.dtype)[..., None]
