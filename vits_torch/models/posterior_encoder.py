"""Posterior encoder: 1x1 pre -> WaveNet -> 1x1 proj -> (m, logs) -> sample z
(port of ``vits_tpu/models/posterior_encoder.py``). Used twice by the
synthesizer: on the linear spectrogram and on the yingram. The sampling noise
``eps`` is passed in; without it z is the mean.
"""

from __future__ import annotations

import torch
from torch import nn

from vits_torch.models.modules import WaveNet, conv1d
from vits_torch.ops.commons import sequence_mask


class PosteriorEncoder(nn.Module):
    def __init__(
        self, in_channels, out_channels, hidden_channels, kernel_size,
        dilation_rate, n_layers, gin_channels=0,
    ):
        super().__init__()
        self.out_channels = out_channels
        self.pre = conv1d(in_channels, hidden_channels, 1)
        self.enc = WaveNet(
            hidden_channels, kernel_size, dilation_rate, n_layers,
            gin_channels=gin_channels,
        )
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_lengths, g=None, eps=None):
        """x: [B, C_in, T]; eps: [B, out, T] standard normal or None ->
        (z, m, logs [B, out, T], x_mask [B, 1, T])."""
        x_mask = sequence_mask(x_lengths, x.shape[2]).unsqueeze(1).to(x.dtype)
        h = self.pre(x) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        if eps is None:
            z = m * x_mask
        else:
            z = (m + eps * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
