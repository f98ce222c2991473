"""Stochastic duration predictor, flow-based (port of
``vits_tpu/models/duration.py``).

Train: a posterior spline flow over (u, z1) conditioned on the text and the
durations gives the per-sample bound nll + logq; its noise ``e_q`` is passed
in. Reverse: 2-channel noise runs the main flows backward (dropping the
unused extra flow) and logw = z0. The text and speaker inputs are detached.
Layout NCL, masks [B, 1, T].
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.models.flows import ConvFlow, ElementwiseAffine, Flip, Log
from perfbench.reference.models.modules import DDSConv, conv1d


class StochasticDurationPredictor(nn.Module):
    def __init__(
        self, in_channels, filter_channels, kernel_size, p_dropout, n_flows=4,
        gin_channels=0,
    ):
        super().__init__()
        self.log_flow = Log()
        self.flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(n_flows):
            self.flows.append(ConvFlow(2, filter_channels, kernel_size, n_layers=3))
            self.flows.append(Flip())

        self.post_pre = conv1d(1, filter_channels, 1)
        self.post_proj = conv1d(filter_channels, filter_channels, 1)
        self.post_convs = DDSConv(filter_channels, kernel_size, 3, p_dropout=p_dropout)
        self.post_flows = nn.ModuleList([ElementwiseAffine(2)])
        for _ in range(4):
            self.post_flows.append(ConvFlow(2, filter_channels, kernel_size, n_layers=3))
            self.post_flows.append(Flip())

        self.pre = conv1d(in_channels, filter_channels, 1)
        self.proj = conv1d(filter_channels, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, 3, p_dropout=p_dropout)
        if gin_channels != 0:
            self.cond = conv1d(gin_channels, filter_channels, 1)

    def _encode_text(self, x, x_mask, g):
        x = self.pre(x.detach())
        if g is not None:
            x = x + self.cond(g.detach())
        x = self.convs(x, x_mask)
        return self.proj(x) * x_mask

    def forward(self, x, x_mask, w, g=None, e_q=None):
        """x: [B, C, T] text encodings; w: [B, 1, T] durations; e_q: [B, 2, T]
        standard normal noise -> per-sample nll + logq [B]."""
        x = self._encode_text(x, x_mask, g)
        h_w = self.post_pre(w)
        h_w = self.post_convs(h_w, x_mask)
        h_w = self.post_proj(h_w) * x_mask

        e_q = e_q * x_mask
        z_q = e_q
        logdet_tot_q = 0.0
        for flow in self.post_flows:
            z_q, logdet_q = flow(z_q, x_mask, g=x + h_w)
            logdet_tot_q = logdet_tot_q + logdet_q
        z_u, z1 = torch.split(z_q, [1, 1], dim=1)
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_tot_q = logdet_tot_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2)
        )
        logq = (
            torch.sum(-0.5 * (math.log(2 * math.pi) + e_q**2) * x_mask, dim=(1, 2))
            - logdet_tot_q
        )

        z0, logdet_tot = self.log_flow(z0, x_mask)
        z = torch.cat([z0, z1], dim=1)
        for flow in self.flows:
            z, logdet = flow(z, x_mask, g=x, reverse=False)
            logdet_tot = logdet_tot + logdet
        nll = (
            torch.sum(0.5 * (math.log(2 * math.pi) + z**2) * x_mask, dim=(1, 2))
            - logdet_tot
        )
        return nll + logq

    def reverse(self, x, x_mask, g=None, z=None, noise_scale=1.0):
        """z: [B, 2, T] standard normal noise -> logw [B, 1, T]."""
        x = self._encode_text(x, x_mask, g)
        flows = list(reversed(self.flows))
        flows = flows[:-2] + [flows[-1]]  # drop the unused extra flow
        z = z * noise_scale
        for flow in flows:
            z = flow(z, x_mask, g=x, reverse=True)
        return z[:, :1]
