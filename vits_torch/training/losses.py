"""GAN and VAE losses: LSGAN, feature matching, masked Gaussian KL (port of
``vits_tpu/training/losses.py``), and MB-iSTFT-VITS's sub-band
multi-resolution STFT loss (``subband_stft_loss``). All loss math is f32:
under the bf16 policy the cast here is the stability boundary.
"""

from __future__ import annotations

import functools

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching x2; the real feature maps are detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN D loss sum((1 - D(y))^2) + D(y_hat)^2 -> (loss, r_losses, g_losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN G loss sum((1 - D(y_hat))^2) -> (loss, per-output losses)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, denom=None) -> torch.Tensor:
    """Masked Gaussian KL between the posterior sample and the expanded
    prior. All [B, T, C], mask [B, T, 1]. The sum is divided by ``denom``
    where it is given (a data-parallel step's shared denominator), else by
    ``sum(z_mask)``."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        a.float() for a in (z_p, logs_q, m_p, logs_p, z_mask)
    )
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if denom is None else denom)


@functools.lru_cache(maxsize=None)
def _hann(win_length: int, device: torch.device) -> torch.Tensor:
    """``torch.hann_window(win_length)`` on ``device``, made once."""
    with torch.inference_mode(False):
        return torch.hann_window(win_length, device=device)


def _stft_magnitude(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> torch.Tensor:
    """[N, T] -> |STFT| [N, frames, fft_size // 2 + 1]: a Hann window of
    ``win_length`` centred in ``fft_size``, reflect-padded centred frames,
    sqrt(clamp(re^2 + im^2, 1e-7)) (ParallelWaveGAN's ``stft``)."""
    spec = torch.stft(x, fft_size, hop, win_length, _hann(win_length, x.device),
                      return_complex=True)
    spec = torch.view_as_real(spec)
    return torch.sqrt(torch.clamp(spec[..., 0] ** 2 + spec[..., 1] ** 2, min=1e-7)).transpose(1, 2)


def subband_stft_loss(y_mb, y_hat_mb, fft_sizes, hop_sizes, win_lengths) -> torch.Tensor:
    """MB-iSTFT-VITS's sub-band loss (``losses.py::subband_stft_loss``,
    ParallelWaveGAN's ``MultiResolutionSTFTLoss``): the real sub-bands y_mb
    [B, N, T] (PQMF analysis of the real segment) against the generated
    y_hat_mb [B, N, T'], both viewed as B * N signals, the generated cut to
    the real's length. At each resolution the spectral convergence
    ||mag_y - mag_y_hat||_F / ||mag_y||_F over the whole batch and the mean
    |log mag_y - log mag_y_hat|; the loss is the mean of each over the
    resolutions, summed."""
    y = y_mb.float().reshape(-1, y_mb.shape[-1])
    y_hat = y_hat_mb.float().reshape(-1, y_hat_mb.shape[-1])[:, : y.shape[-1]]
    sc, mag = 0.0, 0.0
    for fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        m_hat = _stft_magnitude(y_hat, int(fft), int(hop), int(win))
        m = _stft_magnitude(y, int(fft), int(hop), int(win))
        sc = sc + torch.linalg.norm(m - m_hat) / torch.linalg.norm(m)
        mag = mag + torch.mean(torch.abs(torch.log(m) - torch.log(m_hat)))
    n = len(fft_sizes)
    return sc / n + mag / n
