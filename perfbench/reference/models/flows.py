"""Normalizing-flow components (port of ``vits_tpu/models/flows.py``): the
mean-only affine coupling block between posterior and prior, and the spline
flows of the duration predictor.

Layout NCL, masks [B, 1, T]. Each flow returns (y, logdet) forward and y in
reverse.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from perfbench.reference.models.modules import DDSConv, WaveNet, conv1d
from perfbench.reference.ops.spline import piecewise_rational_quadratic_transform


class Flip(nn.Module):
    def forward(self, x, x_mask=None, g=None, reverse=False):
        x = torch.flip(x, [1])
        if not reverse:
            return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return x


class ElementwiseAffine(nn.Module):
    """y = m + exp(logs) * x per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x, x_mask, g=None, reverse=False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            logdet = torch.sum(self.logs * x_mask, dim=(1, 2))
            return y, logdet
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class Log(nn.Module):
    """y = log(clamp(x, 1e-5))."""

    def forward(self, x, x_mask, g=None, reverse=False):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class ResidualCouplingLayer(nn.Module):
    """Affine coupling with a WaveNet conditioner; the output head starts at
    zero so the flow starts as the identity."""

    def __init__(
        self, channels, hidden_channels, kernel_size, dilation_rate, n_layers,
        p_dropout=0.0, gin_channels=0, mean_only=False,
    ):
        super().__init__()
        self.half_channels = channels // 2
        self.mean_only = mean_only
        self.pre = conv1d(self.half_channels, hidden_channels, 1)
        self.enc = WaveNet(
            hidden_channels, kernel_size, dilation_rate, n_layers,
            gin_channels=gin_channels, p_dropout=p_dropout,
        )
        self.post = conv1d(
            hidden_channels, self.half_channels * (2 - mean_only), 1, zero_init=True
        )

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = torch.split(x, [self.half_channels] * 2, dim=1)
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = self.post(h) * x_mask
        if not self.mean_only:
            m, logs = torch.split(stats, [self.half_channels] * 2, dim=1)
        else:
            m, logs = stats, torch.zeros_like(stats)
        if not reverse:
            x1 = m + x1 * torch.exp(logs) * x_mask
            return torch.cat([x0, x1], dim=1), torch.sum(logs, dim=(1, 2))
        x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + flip); couplings at even indices of ``flows``."""

    def __init__(
        self, channels, hidden_channels, kernel_size, dilation_rate, n_layers,
        n_flows=4, gin_channels=0,
    ):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(
                ResidualCouplingLayer(
                    channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                    gin_channels=gin_channels, mean_only=True,
                )
            )
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse=False):
        if not reverse:
            for flow in self.flows:
                x, _ = flow(x, x_mask, g=g, reverse=False)
        else:
            for flow in reversed(self.flows):
                x = flow(x, x_mask, g=g, reverse=True)
        return x


class ConvFlow(nn.Module):
    """Spline coupling: DDSConv conditioner -> RQ spline on the second half."""

    def __init__(
        self, in_channels, filter_channels, kernel_size, n_layers, num_bins=10,
        tail_bound=5.0,
    ):
        super().__init__()
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.half_channels = in_channels // 2
        self.pre = conv1d(self.half_channels, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = conv1d(
            filter_channels, self.half_channels * (num_bins * 3 - 1), 1, zero_init=True
        )

    def forward(self, x, x_mask, g=None, reverse=False):
        x0, x1 = torch.split(x, [self.half_channels] * 2, dim=1)
        h = self.pre(x0)
        h = self.convs(h, x_mask, g=g)
        h = self.proj(h) * x_mask
        b, _, t = x0.shape
        # [B, half*(3K-1), T] -> [B, half, T, 3K-1]
        h = h.reshape(b, self.half_channels, -1, t).permute(0, 1, 3, 2)
        denom = math.sqrt(self.filter_channels)
        k = self.num_bins
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / denom, h[..., k : 2 * k] / denom, h[..., 2 * k :],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound,
        )
        x = torch.cat([x0, x1], dim=1) * x_mask
        if not reverse:
            return x, torch.sum(logabsdet * x_mask, dim=(1, 2))
        return x
