"""VITS's discriminator written plainly: HiFi-GAN's multi-period
discriminator beside one scale discriminator, what MB-iSTFT-VITS trains its
generator against.

Kim, Kong and Son, "Conditional Variational Autoencoder with Adversarial
Learning for End-to-End Text-to-Speech", ICML 2021; github.com/jaywalnut310/vits
``models.py`` (``DiscriminatorP``, ``DiscriminatorS``,
``MultiPeriodDiscriminator``), which MB-iSTFT-VITS's ``models.py`` repeats.

- ``DiscriminatorP(period)``: reflect-pad the waveform [B, 1, T] on the right
  to a multiple of the period, view it as [B, 1, T / p, p]; five ``Conv2d``
  of kernel (5, 1), padding (2, 0), 1 -> 32 -> 128 -> 512 -> 1024 at stride
  (3, 1), then 1024 -> 1024 at stride 1, each followed by leaky_relu(0.1) and
  kept; ``conv_post`` 1024 -> 1, kernel (3, 1), padding (1, 0), kept; the
  output flattened.
- ``DiscriminatorS``: ``Conv1d`` 1 -> 16 (k15, p7), 16 -> 64 (k41, s4, g4,
  p20), 64 -> 256 (k41, s4, g16, p20), 256 -> 1024 (k41, s4, g64, p20), 1024 ->
  1024 (k41, s4, g256, p20), 1024 -> 1024 (k5, p2), each followed by
  leaky_relu(0.1) and kept; ``conv_post`` 1024 -> 1 (k3, p1), kept.
- ``MultiPeriodDiscriminator``: ``[DiscriminatorS] + [DiscriminatorP(p) for p
  in (2, 3, 5, 7, 11)]``, each called on the real waveform and then on the
  generated one.

Every conv weight-normed (``use_spectral_norm: false``), the legacy
``weight_g`` / ``weight_v`` leaves, named as VITS's ``net_d`` state dict.

Departures from the published code: ``probe=True`` builds the same layers,
kernels, strides, groups' pattern and periods at a few channels, for tests on
the CPU. Float32; the benchmark runs it with TF32 off.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.models.modules import LRELU_SLOPE, weight_norm

PERIODS = (2, 3, 5, 7, 11)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


class DiscriminatorP(nn.Module):
    def __init__(self, period, channels=(32, 128, 512, 1024, 1024), kernel_size=5, stride=3):
        super().__init__()
        self.period = period
        c = (1, *channels)
        pad = (get_padding(kernel_size, 1), 0)
        self.convs = nn.ModuleList([
            weight_norm(nn.Conv2d(c[0], c[1], (kernel_size, 1), (stride, 1), padding=pad)),
            weight_norm(nn.Conv2d(c[1], c[2], (kernel_size, 1), (stride, 1), padding=pad)),
            weight_norm(nn.Conv2d(c[2], c[3], (kernel_size, 1), (stride, 1), padding=pad)),
            weight_norm(nn.Conv2d(c[3], c[4], (kernel_size, 1), (stride, 1), padding=pad)),
            weight_norm(nn.Conv2d(c[4], c[5], (kernel_size, 1), 1, padding=pad)),
        ])
        self.conv_post = weight_norm(nn.Conv2d(c[5], 1, (3, 1), 1, padding=(1, 0)))

    def forward(self, x):
        fmap = []
        b, c, t = x.shape
        if t % self.period != 0:  # pad first
            n_pad = self.period - (t % self.period)
            x = F.pad(x, (0, n_pad), "reflect")
            t = t + n_pad
        x = x.view(b, c, t // self.period, self.period)
        for layer in self.convs:
            x = layer(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        x = torch.flatten(x, 1, -1)
        return x, fmap


class DiscriminatorS(nn.Module):
    def __init__(self, channels=(16, 64, 256, 1024, 1024, 1024), groups=(1, 4, 16, 64, 256, 1)):
        super().__init__()
        c, g = (1, *channels), groups
        self.convs = nn.ModuleList([
            weight_norm(nn.Conv1d(c[0], c[1], 15, 1, padding=7, groups=g[0])),
            weight_norm(nn.Conv1d(c[1], c[2], 41, 4, groups=g[1], padding=20)),
            weight_norm(nn.Conv1d(c[2], c[3], 41, 4, groups=g[2], padding=20)),
            weight_norm(nn.Conv1d(c[3], c[4], 41, 4, groups=g[3], padding=20)),
            weight_norm(nn.Conv1d(c[4], c[5], 41, 4, groups=g[4], padding=20)),
            weight_norm(nn.Conv1d(c[5], c[6], 5, 1, padding=2, groups=g[5])),
        ])
        self.conv_post = weight_norm(nn.Conv1d(c[6], 1, 3, 1, padding=1))

    def forward(self, x):
        fmap = []
        for layer in self.convs:
            x = layer(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        x = torch.flatten(x, 1, -1)
        return x, fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, probe: bool = False):
        super().__init__()
        if probe:
            discs = [DiscriminatorS((4, 16, 32, 64, 64, 64), (1, 4, 8, 16, 16, 1))]
            discs += [DiscriminatorP(i, (4, 8, 16, 32, 32)) for i in PERIODS]
        else:
            discs = [DiscriminatorS()] + [DiscriminatorP(i) for i in PERIODS]
        self.discriminators = nn.ModuleList(discs)

    def forward(self, y, y_hat):
        y_d_rs = []
        y_d_gs = []
        fmap_rs = []
        fmap_gs = []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def build(hps, device=None) -> MultiPeriodDiscriminator:
    """The discriminator of a configuration (``model.discriminator_size``
    ``probe`` for the test widths), on ``device``."""
    probe = str(hps.model.get("discriminator_size", "flagship")) == "probe"
    with torch.device(device or "cpu"):
        return MultiPeriodDiscriminator(probe=probe).to(device or "cpu")
