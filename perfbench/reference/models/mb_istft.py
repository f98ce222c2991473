"""MB-iSTFT-VITS for serving, written plainly: what the benchmark's
``ljs_mbistft`` cells and the port's tests hold ``vits_torch`` to.

Kawamura, Shirahata, Yamamoto and Tachibana, "Lightweight and High-Fidelity
End-to-End Text-to-Speech with Multi-Band Generation and Inverse Short-Time
Fourier Transform", ICASSP 2023, arXiv:2210.15975; code and config:
github.com/MasayaKawamura/MB-iSTFT-VITS (``models.py``, ``stft.py``,
``pqmf.py``, ``configs/ljs_mb_istft_vits.json``).

Scope: the text encoder without a language embedding, the stochastic
duration predictor in reverse, length regulation, the prior sample, the
reverse flow and the multi-band iSTFT decoder (batch 1 is all the serving
comparison asks of it). The frozen modules of ``perfbench/reference`` are
reused by import: the relative-position transformer, the duration
predictor, the coupling flow, HiFi-GAN's ``ResBlock1``, the weight-normed
convs, the PQMF filter design and its zero-stuff-and-convolve synthesis. It
keeps the names ``reference/serve.py::synth_piece`` calls (``text_encoder``,
``_speaker_embedding``, ``duration_predictor.reverse``, ``_expand_and_flow``,
``waveform_decoder``), and the parameter names of the port's model built
from the same configuration, so the benchmark's seeded weights load into
both.

The decoder, from z [B, 192, T]: weight-normed ``conv_pre`` (kernel 7) to
512 channels; two stages of leaky_relu(0.1), a weight-normed transposed conv
(stride 4, kernel 16, padding 6: 4x the length; 512 -> 256 -> 128 channels)
and the mean of three ``ResBlock1`` (kernels 3, 7, 11, dilations 1, 3, 5);
leaky_relu(0.01), reflection pad (1, 0), weight-normed
``subband_conv_post`` (kernel 7) to 4 x 18 channels; magnitude exp of the
first 9 of each band's 18, phase pi sin of the other 9; an inverse STFT of
each band (n_fft 16, hop 4, periodic Hann window of 16, centred), here an
explicit complex inverse DFT of every frame and an overlap-add loop over the
frames with the squared window's envelope, then the centre trim; PQMF
synthesis of the 4 bands (62 taps, beta 9). T frames give 256 T samples.

Departures from the published description:

- the text ids are the port's 71-symbol IPA inventory (``text/symbols.py``),
  not VITS's 178 espeak symbols;
- ``use_sdp`` is taken as true and the PQMF prototype's cutoff as 0.15 (the
  published files are not read here; the configuration lists both under
  ``assumed``);
- the model holds the posterior encoder (linear spectrogram -> z, 16 WaveNet
  layers at 192 channels) for its parameters alone: serving does not run it;
- one speaker: no speaker embedding and no conditioning of the decoder.

Float32; the benchmark runs it with TF32 off (``precision.exact``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.models.attention import RelativePositionTransformer
from perfbench.reference.models.duration import StochasticDurationPredictor
from perfbench.reference.models.flows import ResidualCouplingBlock
from perfbench.reference.models.hifigan import ResBlock1
from perfbench.reference.models.modules import (
    LRELU_SLOPE,
    ConvTranspose1d,
    conv1d,
    embedding,
    weight_norm,
)
from perfbench.reference.models.posterior_encoder import PosteriorEncoder
from perfbench.reference.ops.commons import generate_path, sequence_mask
from perfbench.reference.ops.pqmf import PQMF
from perfbench.reference.text.symbols import symbols

PQMF_CUTOFF = 0.15


class TextEncoder(nn.Module):
    """VITS's text encoder: symbol embedding x sqrt(hidden) -> transformer ->
    1x1 projection to (m, logs); language ids are taken and not read."""

    def __init__(self, n_vocab, out_channels, hidden_channels, filter_channels, n_heads,
                 n_layers, kernel_size, p_dropout):
        super().__init__()
        self.n_vocab = n_vocab
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = embedding(n_vocab, hidden_channels, hidden_channels**-0.5)
        self.encoder = RelativePositionTransformer(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size, p_dropout)
        self.proj = conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, t, x_lengths):
        x = self.emb(x.clamp(0, self.n_vocab - 1)) * math.sqrt(self.hidden_channels)
        x = x.transpose(1, 2)
        x_mask = sequence_mask(x_lengths, x.shape[2]).unsqueeze(1).to(x.dtype)
        x = self.encoder(x * x_mask, x_mask)
        stats = self.proj(x) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return x, m, logs, x_mask


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """mag, phase [..., n_fft // 2 + 1, F] -> [..., hop * (F - 1)]: each
    frame's complex inverse DFT over all n_fft bins (the upper ones the
    conjugates of the lower; the DC and Nyquist bins' imaginary parts
    dropped, as a real inverse drops them), times the window, added at
    hop * f frame by frame, divided by the squared window added the same way,
    and trimmed by n_fft // 2 at both ends."""
    n_freqs = n_fft // 2 + 1
    spec = torch.polar(mag.float(), phase.float())  # [..., n_freqs, F] complex64
    real_edges = torch.zeros(n_freqs, dtype=torch.bool, device=spec.device)
    real_edges[0] = True
    if n_fft % 2 == 0:
        real_edges[-1] = True
    spec = torch.where(real_edges[:, None], spec.real.to(spec.dtype), spec)
    upper = spec[..., 1: n_fft - n_freqs + 1, :].flip(-2).conj()
    full = torch.cat([spec, upper], dim=-2)  # [..., n_fft, F]
    k = np.arange(n_fft)
    kernel = np.exp(2j * np.pi * np.outer(k, k) / n_fft) / n_fft  # [k, n]
    kernel = torch.from_numpy(kernel.astype(np.complex64)).to(spec.device)
    frames = torch.matmul(full.transpose(-1, -2), kernel).real  # [..., F, n_fft]
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    ).to(spec.device)
    frames = frames * window
    n_frames = frames.shape[-2]
    length = n_fft + hop * (n_frames - 1)
    out = frames.new_zeros((*frames.shape[:-2], length))
    env = np.zeros(length, np.float64)
    w2 = window.double().cpu().numpy() ** 2
    for f in range(n_frames):
        out[..., f * hop: f * hop + n_fft] += frames[..., f, :]
        env[f * hop: f * hop + n_fft] += w2
    trim = n_fft // 2
    env_t = torch.from_numpy(env[trim: length - trim].astype(np.float32)).to(out.device)
    return out[..., trim: length - trim] / env_t


class MultiBandISTFTDecoder(nn.Module):
    """The decoder of the module docstring, float32."""

    def __init__(self, initial_channel, resblock_kernel_sizes, resblock_dilation_sizes,
                 upsample_rates, upsample_initial_channel, upsample_kernel_sizes, subbands,
                 n_fft, hop):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.subbands, self.n_fft, self.hop = subbands, n_fft, hop
        self.conv_pre = conv1d(initial_channel, upsample_initial_channel, 7, padding=3,
                               use_weight_norm=True)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(weight_norm(ConvTranspose1d(
                upsample_initial_channel // (2**i), ch, k, stride=u, padding=(k - u) // 2)))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.subband_conv_post = conv1d(ch, subbands * (n_fft + 2), 7, padding=3,
                                        use_weight_norm=True)
        self.pqmf = PQMF(subbands, 62, PQMF_CUTOFF, 9.0)

    def forward(self, x, g=None):
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = sum(self.resblocks[i * self.num_kernels + j](x) for j in range(self.num_kernels))
            x = xs / self.num_kernels
        x = F.leaky_relu(x)
        x = F.pad(x, (1, 0), mode="reflect")
        x = self.subband_conv_post(x)
        b, _, t = x.shape
        x = x.reshape(b, self.subbands, self.n_fft + 2, t)
        half = self.n_fft // 2 + 1
        bands = istft(torch.exp(x[:, :, :half]), math.pi * torch.sin(x[:, :, half:]),
                      self.n_fft, self.hop)  # [B, subbands, hop * (t - 1)]
        return self.pqmf.synthesis(bands.transpose(1, 2)).transpose(1, 2)


class MBISTFTSynthesizer(nn.Module):
    """The serving model of the module docstring, one speaker."""

    def __init__(self, hps, num_chars: int):
        super().__init__()
        m, d = hps.model, hps.data
        self.inter_channels = inter = m.inter_channels
        hidden = m.hidden_channels
        self.text_encoder = TextEncoder(num_chars, inter, hidden, m.filter_channels, m.n_heads,
                                        m.n_layers, m.kernel_size, m.p_dropout)
        self.waveform_decoder = MultiBandISTFTDecoder(
            inter, m.resblock_kernel_sizes, m.resblock_dilation_sizes, m.upsample_rates,
            m.upsample_initial_channel, m.upsample_kernel_sizes, m.subbands,
            m.gen_istft_n_fft, m.gen_istft_hop_size)
        self.posterior_encoder = PosteriorEncoder(
            d.filter_length // 2 + 1, inter, hidden, 5, 1, int(m.get("posterior_layers", 16)))
        self.flow = ResidualCouplingBlock(inter, hidden, 5, 1, int(m.get("flow_wn_layers", 4)),
                                          n_flows=int(m.get("flow_n_flows", 4)))
        self.duration_predictor = StochasticDurationPredictor(
            hidden, 192, 3, 0.5, int(m.get("dur_n_flows", 4)))

    @property
    def device(self) -> torch.device:
        return self.text_encoder.proj.weight.device

    def _speaker_embedding(self, sid):
        return None

    def _expand_and_flow(self, w_ceil, m_p, logs_p, x_mask, g, eps, noise_scale, max_frames,
                         scope_shift):
        """w_ceil [B, T_x]; m_p, logs_p [B, C, T_x]; eps [B, C, max_frames] ->
        (z * y_mask [B, C, max_frames], y_mask, None); ``scope_shift`` unread."""
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), min=1).to(torch.int32)
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames).unsqueeze(1).to(m_p.dtype)
        attn = generate_path(w_ceil, y_mask.transpose(1, 2) * x_mask)  # [B, T_y, T_x]
        m_exp = torch.matmul(attn, m_p.transpose(1, 2)).transpose(1, 2)
        logs_exp = torch.matmul(attn, logs_p.transpose(1, 2)).transpose(1, 2)
        z_p = m_exp + eps * torch.exp(logs_exp) * noise_scale
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        return z * y_mask, y_mask, None


def build(hps, device=None) -> MBISTFTSynthesizer:
    """The reference model of a configuration, on ``device`` (the CPU unless
    named), in eval mode."""
    with torch.device(device or "cpu"):
        model = MBISTFTSynthesizer(hps, len(symbols))
    return model.to(device or "cpu").eval()
