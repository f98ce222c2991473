"""Posterior encoder: 1x1 pre -> WaveNet -> 1x1 proj -> (m, logs) -> sample z
(port of ``vits_tpu/models/posterior_encoder.py``). Used twice by the
synthesizer: on the linear spectrogram and on the yingram. The sampling noise
``eps`` is passed in; without it z is the mean.

``bf16=True`` runs pre, the WaveNet and proj in bfloat16 (input,
conditioning and mask cast at entry, parameters cast at each conv); the
stats, the mask and the sample are f32, as in the JAX module.
"""

from __future__ import annotations

import torch
from torch import nn

from perfbench.reference.models.modules import WaveNet, conv1d
from perfbench.reference.ops.commons import sequence_mask


class PosteriorEncoder(nn.Module):
    def __init__(
        self, in_channels, out_channels, hidden_channels, kernel_size,
        dilation_rate, n_layers, gin_channels=0, bf16=False,
    ):
        super().__init__()
        self.bf16 = bf16
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
        x_mask = sequence_mask(x_lengths, x.shape[2]).unsqueeze(1).to(torch.float32)
        if self.bf16:
            x = x.to(torch.bfloat16)
            g = g.to(torch.bfloat16) if g is not None else None
        mask = x_mask.to(x.dtype)
        h = self.pre(x) * mask
        h = self.enc(h, mask, g=g)
        stats = (self.proj(h) * mask).float()
        m, logs = torch.split(stats, self.out_channels, dim=1)
        if eps is None:
            z = m * x_mask
        else:
            z = (m + eps * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask
