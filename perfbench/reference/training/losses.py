"""GAN and VAE losses: LSGAN, feature matching, masked Gaussian KL (port of
``vits_tpu/training/losses.py``). All loss math is f32: under the bf16
policy the cast here is the stability boundary.
"""

from __future__ import annotations

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
