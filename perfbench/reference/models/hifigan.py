"""Hierarchical HiFi-GAN generator (port of ``vits_tpu/models/hifigan.py``).

Weight-normed transposed convs (padding u//2 + u%2, output_padding u%2, so
T_out = T_in * prod(rates)), MRF resblocks, and bias-free ``conv_posts`` for
the last three stages. The hierarchical heads use the default-slope
leaky_relu (0.01), not 0.1, as the reference does. Layout NCL.

``bf16=True`` runs the whole stack in bfloat16 (input and conditioning cast
at entry; parameters stay f32 and are cast at each conv); the ``tanh``
outputs are cast back to f32, as in the JAX module.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.models.modules import LRELU_SLOPE, ConvTranspose1d, conv1d, weight_norm


def _wn_conv(channels, kernel_size, dilation=1):
    return conv1d(
        channels, channels, kernel_size, dilation=dilation,
        padding=(kernel_size * dilation - dilation) // 2, use_weight_norm=True,
        init_std=0.01,
    )


class ResBlock1(nn.Module):
    """len(dilation) x (dilated conv + conv) with leaky-relu pre-activations."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(_wn_conv(channels, kernel_size, d) for d in dilation)
        self.convs2 = nn.ModuleList(_wn_conv(channels, kernel_size) for _ in dilation)

    def forward(self, x, x_mask=None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            xt = c1(xt)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x


class ResBlock2(nn.Module):
    """len(dilation) x dilated conv variant."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(_wn_conv(channels, kernel_size, d) for d in dilation)

    def forward(self, x, x_mask=None):
        for c in self.convs:
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x


class HiFiGANGenerator(nn.Module):
    """conv_pre -> [lrelu -> up -> MRF] x N -> lrelu -> conv_post -> tanh."""

    def __init__(
        self, initial_channel, resblock_type, resblock_kernel_sizes,
        resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
        upsample_kernel_sizes, gin_channels=0, bf16=False,
    ):
        super().__init__()
        self.bf16 = bf16
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        self.conv_pre = conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        if gin_channels != 0:
            self.cond = conv1d(gin_channels, upsample_initial_channel, 1)
        resblock_cls = ResBlock1 if str(resblock_type) == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            up = ConvTranspose1d(
                upsample_initial_channel // (2**i), ch, k, stride=u,
                padding=u // 2 + u % 2, output_padding=u % 2,
            )
            nn.init.normal_(up.weight, 0.0, 0.01)
            self.ups.append(weight_norm(up))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_posts = nn.ModuleList(
            conv1d(upsample_initial_channel // (2 ** (self.num_upsamples - 2 + i)), 1, 7,
                   padding=3, bias=False)
            for i in range(3)
        )

    def _body(self, x, g, hier: bool):
        if self.bf16:
            x = x.to(torch.bfloat16)
            g = g.to(torch.bfloat16) if g is not None else None
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        outs = []
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            z_sum = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                z_sum = r if z_sum is None else z_sum + r
            x = z_sum / self.num_kernels
            first_head = self.num_upsamples - 3
            if (hier and i >= first_head) or i == self.num_upsamples - 1:
                post = self.conv_posts[i - first_head]
                outs.append(torch.tanh(post(F.leaky_relu(x))).float())
        return outs

    def forward(self, x, g=None):
        """x: [B, C, T] -> final-scale waveform [B, 1, T * prod(rates)]."""
        return self._body(x, g, hier=False)[-1]

    def hier_forward(self, x, g=None):
        """3 waveforms at 1/4x, 1/2x and 1x the final rate."""
        return self._body(x, g, hier=True)
