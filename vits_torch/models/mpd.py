"""VITS's discriminator, HiFi-GAN's multi-period discriminator beside one
scale discriminator (Kim, Kong and Son 2021, ``models.py::
MultiPeriodDiscriminator`` of github.com/jaywalnut310/vits), which
MB-iSTFT-VITS trains its generator against.

- ``DiscriminatorP(period)``: the waveform [B, 1, T] reflect-padded on the
  right to a multiple of the period and viewed as [B, 1, T / p, p]; five
  ``Conv2d`` of kernel (5, 1), padding (2, 0), channels 1 -> 32 -> 128 -> 512
  -> 1024 at stride (3, 1), then 1024 -> 1024 at stride 1, each followed by
  leaky_relu(0.1); ``conv_post`` 1024 -> 1, kernel (3, 1), padding (1, 0).
- ``DiscriminatorS``: ``Conv1d`` 1 -> 16 (k15), 16 -> 64 (k41, s4, g4), 64 ->
  256 (g16), 256 -> 1024 (g64), 1024 -> 1024 (g256), 1024 -> 1024 (k5), each
  followed by leaky_relu(0.1); ``conv_post`` 1024 -> 1, kernel 3. The four
  grouped convs are ``GroupedConv1d``: the same forward, their input
  gradient from ``ops/grouped_conv.py`` (a CUDA kernel on the card).
- ``MultiPeriodDiscriminator``: the scale discriminator, then the period
  discriminators of 2, 3, 5, 7 and 11.

Every conv is weight-normed (``use_spectral_norm: false``, the legacy
``weight_g`` / ``weight_v`` keys), and the leaf names are those of VITS's
``net_d`` state dict (``discriminators.N.convs.M``, ``discriminators.N.
conv_post``). Each discriminator returns its flattened ``conv_post`` output
[B, N] and its feature maps, the activation after each conv and the
``conv_post`` output (7 of the scale discriminator, 6 of a period one), in
the published layout (NCL, NCHW); float32.

``probe=True`` keeps the layers, kernels, strides and periods at a few
channels (the test and probe size the configuration's
``discriminator_size: probe`` names).

Spans (``utils/profiling.py``): ``vits.disc.msd`` around the scale
discriminator, ``vits.disc.mpd`` around the five period discriminators;
``vits.disc.grouped_dgrad`` around each grouped conv's backward (counter
``disc.grouped_dgrad``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from vits_torch.models.modules import LRELU_SLOPE, Conv1d, _in_dtype_of, conv1d, weight_norm
from vits_torch.models.synthesizer import resolve_device
from vits_torch.ops.grouped_conv import GroupedConv1dFunction
from vits_torch.utils.profiling import span

PERIODS = (2, 3, 5, 7, 11)
# (channels, groups) of the scale discriminator's convs and the period
# discriminators' channels: published, and at the probe size
MSD_CHANNELS = ((16, 64, 256, 1024, 1024, 1024), (1, 4, 16, 64, 256, 1))
MSD_PROBE = ((4, 16, 32, 64, 64, 64), (1, 4, 8, 16, 16, 1))
MPD_CHANNELS = (32, 128, 512, 1024, 1024)
MPD_PROBE = (4, 8, 16, 32, 32)


def _conv2d(in_ch: int, out_ch: int, kernel: int, stride: int, padding: int) -> nn.Module:
    """A weight-normed ``Conv2d`` of kernel (kernel, 1) along the folded time."""
    return weight_norm(nn.Conv2d(in_ch, out_ch, (kernel, 1), (stride, 1), padding=(padding, 0)))


class GroupedConv1d(Conv1d):
    """The scale discriminator's grouped conv: ``Conv1d``'s forward (cuDNN on
    the card), its input gradient ``ops/grouped_conv.py::grouped_dgrad`` (the
    kernel on the card, the plain version on the CPU), its weight and bias
    gradients cuDNN's. It computes in its input's dtype as ``Conv1d`` does,
    and under autocast casts its operands as autocast casts ``F.conv1d``'s
    (``grouped_dgrad`` widens half gradients to float32 for the kernel)."""

    def _conv_forward(self, input, weight, bias):
        return _in_dtype_of(input, weight, bias, self._grouped)

    def _grouped(self, x, weight, bias):
        dev = x.device.type
        if torch.is_autocast_enabled(dev):
            dt = torch.get_autocast_dtype(dev)
            x, weight = x.to(dt), weight.to(dt)
            bias = None if bias is None else bias.to(dt)
        with torch.autocast(dev, enabled=False):
            return GroupedConv1dFunction.apply(x, weight, bias, self.stride[0],
                                               self.padding[0], self.groups)


class DiscriminatorP(nn.Module):
    """The period discriminator of the module docstring."""

    def __init__(self, period: int, channels=MPD_CHANNELS, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        ins = (1, *channels[:-1])
        strides = [stride] * (len(channels) - 1) + [1]
        self.convs = nn.ModuleList(
            _conv2d(i, o, kernel_size, s, pad) for i, o, s in zip(ins, channels, strides))
        self.conv_post = _conv2d(channels[-1], 1, 3, 1, 1)

    def forward(self, x):
        """x: [B, 1, T] -> (logits [B, N], 6 feature maps [B, C, T', p])."""
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class DiscriminatorS(nn.Module):
    """The scale discriminator of the module docstring."""

    def __init__(self, channels=MSD_CHANNELS[0], groups=MSD_CHANNELS[1]):
        super().__init__()
        kernels, strides, pads = (15, 41, 41, 41, 41, 5), (1, 4, 4, 4, 4, 1), (7, 20, 20, 20, 20, 2)
        ins = (1, *channels[:-1])
        self.convs = nn.ModuleList(
            weight_norm(GroupedConv1d(i, o, k, stride=s, groups=g, padding=p)) if g > 1
            else conv1d(i, o, k, stride=s, padding=p, use_weight_norm=True)
            for i, o, k, s, g, p in zip(ins, channels, kernels, strides, groups, pads))
        self.conv_post = conv1d(channels[-1], 1, 3, padding=1, use_weight_norm=True)

    def forward(self, x):
        """x: [B, 1, T] -> (logits [B, N], 7 feature maps [B, C, T'])."""
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """``[DiscriminatorS] + [DiscriminatorP(p) for p in PERIODS]``."""

    def __init__(self, probe: bool = False, device=None):
        super().__init__()
        msd = MSD_PROBE if probe else MSD_CHANNELS
        mpd = MPD_PROBE if probe else MPD_CHANNELS
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(*msd)] + [DiscriminatorP(p, mpd) for p in PERIODS])
        self.to(resolve_device(device))

    def forward(self, y, y_hat):
        """Real and generated waveforms [B, 1, T] -> (y_d_rs, y_d_gs, fmap_rs,
        fmap_gs), one entry a discriminator. Each runs on the real and the
        generated batch together (one batch of 2B, where VITS makes two calls:
        the same products row by row)."""
        b = y.shape[0]
        both = torch.cat([y, y_hat], dim=0)
        msd, *mpd = self.discriminators
        with span("disc.msd"):
            outs = [msd(both)]
        with span("disc.mpd"):
            outs += [d(both) for d in mpd]
        return ([logits[:b] for logits, _ in outs], [logits[b:] for logits, _ in outs],
                [[f[:b] for f in fmap] for _, fmap in outs],
                [[f[b:] for f in fmap] for _, fmap in outs])
