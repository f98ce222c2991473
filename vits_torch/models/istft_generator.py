"""Multi-band iSTFT generator of MB-iSTFT-VITS (Kawamura et al., ICASSP 2023,
arXiv:2210.15975; ``models.py::Multiband_iSTFT_Generator`` of
github.com/MasayaKawamura/MB-iSTFT-VITS).

Layout NCL, from z [B, C, T]:

- ``conv_pre``: weight-normed conv, C -> ``upsample_initial_channel``, kernel 7
  (plus ``cond(g)`` where ``gin_channels`` is set, as the HiFi-GAN decoder);
- per stage i: leaky_relu(0.1), ``ups[i]`` (weight-normed transposed conv,
  channels halved, stride u, kernel k, padding (k - u) // 2, so T_out = u T),
  then the mean of the stage's MRF blocks (``hifigan.py::ResBlock1``);
- leaky_relu at the default slope 0.01, reflection pad (1, 0),
  ``subband_conv_post`` (weight-normed conv to ``subbands * (n_fft + 2)``
  channels, kernel 7), reshaped to [B, subbands, n_fft + 2, T'];
- magnitude exp(x[:, :, :n_fft // 2 + 1]), phase pi sin(x[:, :, n_fft // 2 + 1:]);
  one inverse STFT a sub-band (``ops/stft.py::InverseSTFT``: n_fft, hop,
  periodic Hann window of n_fft, centred), then PQMF synthesis over the
  sub-bands (``ops/pqmf.py``; 62 taps, cutoff 0.15, beta 9); no tanh.

With rates 4-4, n_fft 16, hop 4 and 4 sub-bands, T frames give 256 T samples.
The leaf names are the published ones (``conv_pre``, ``ups.N``,
``resblocks.N``, ``subband_conv_post``).

``bf16=True`` follows the HiFi-GAN decoder's policy: input and conditioning
cast to bfloat16 at entry, every conv computed there (parameters stay f32);
the head (exp, sin, the inverse STFT and the PQMF) runs in float32 from the
last conv's output.

``forward`` returns the waveform (serving); ``train_forward`` also returns
the sub-band signals, which MB-iSTFT-VITS's sub-band STFT loss compares with
the PQMF analysis of the real segment.

Spans (``utils/profiling.py``): ``vits.decode.istft`` around the head.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from vits_torch.models.hifigan import ResBlock1
from vits_torch.models.modules import LRELU_SLOPE, ConvTranspose1d, conv1d, weight_norm
from vits_torch.ops.pqmf import PQMF
from vits_torch.ops.stft import InverseSTFT
from vits_torch.utils.profiling import span

# the PQMF prototype's cutoff (assumed: the repository's file is not read here)
PQMF_CUTOFF = 0.15


class MultiBandISTFTGenerator(nn.Module):
    """conv_pre -> [lrelu -> up -> MRF] x N -> lrelu -> pad -> sub-band conv
    -> iSTFT a band -> PQMF synthesis (see the module docstring)."""

    def __init__(
        self, initial_channel, resblock_kernel_sizes, resblock_dilation_sizes,
        upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
        subbands=4, gen_istft_n_fft=16, gen_istft_hop_size=4, gin_channels=0, bf16=False,
    ):
        super().__init__()
        self.bf16 = bf16
        self.num_kernels = len(resblock_kernel_sizes)
        self.subbands = subbands
        self.n_fft = gen_istft_n_fft
        self.conv_pre = conv1d(initial_channel, upsample_initial_channel, 7, padding=3,
                               use_weight_norm=True)
        if gin_channels != 0:
            self.cond = conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            up = ConvTranspose1d(upsample_initial_channel // (2**i), ch, k, stride=u,
                                 padding=(k - u) // 2)
            nn.init.normal_(up.weight, 0.0, 0.01)
            self.ups.append(weight_norm(up))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.subband_conv_post = conv1d(ch, subbands * (gen_istft_n_fft + 2), 7, padding=3,
                                        use_weight_norm=True, init_std=0.01)
        self.istft = InverseSTFT(gen_istft_n_fft, gen_istft_hop_size)
        self.pqmf = PQMF(subbands, 62, PQMF_CUTOFF, 9.0)

    def _head_input(self, x, g):
        """conv_pre -> [lrelu -> up -> MRF] x N -> lrelu -> pad -> sub-band conv:
        [B, C, T] -> [B, subbands * (n_fft + 2), T']."""
        if self.bf16:
            x = x.to(torch.bfloat16)
            g = g.to(torch.bfloat16) if g is not None else None
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            z_sum = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x)
                z_sum = r if z_sum is None else z_sum + r
            x = z_sum / self.num_kernels
        return self.subband_conv_post(F.pad(F.leaky_relu(x), (1, 0), mode="reflect"))

    def _bands(self, x):
        """exp/sin, an inverse STFT a band, in float32: [B, subbands * (n_fft +
        2), T'] -> the sub-band signals [B, subbands, hop * (T' - 1)]."""
        x = x.float().unflatten(1, (self.subbands, self.n_fft + 2))
        half = self.n_fft // 2 + 1
        return self.istft(torch.exp(x[:, :, :half]), math.pi * torch.sin(x[:, :, half:]))

    def forward(self, x, g=None):
        """x: [B, C, T] -> waveform [B, 1, T * prod(rates) * hop * subbands], f32."""
        x = self._head_input(x, g)
        with span("decode.istft"):
            return self.pqmf.synthesis(self._bands(x).transpose(1, 2)).transpose(1, 2)

    def train_forward(self, x, g=None):
        """The training call: x [B, C, T] -> (waveform [B, 1, 256 T], the
        sub-band signals before the PQMF synthesis [B, subbands, 64 T] at the
        published rates), f32; the same kernels as ``forward``."""
        x = self._head_input(x, g)
        with span("decode.istft"):
            bands = self._bands(x)
            return self.pqmf.synthesis(bands.transpose(1, 2)).transpose(1, 2), bands
