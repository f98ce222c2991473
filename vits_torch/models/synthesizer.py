"""SynthesizerTrn: conditional VAE + flow + hierarchical HiFi-GAN generator
with PITS yingram pitch control (port of ``vits_tpu/models/synthesizer.py``).

Two entry points of the JAX model are ported here:
  * ``forward`` (JAX ``__call__``): the generator's training forward. Text
    encoder -> spec and pitch posteriors -> flow -> neg-cross-entropy lattice
    -> MAS (the CUDA kernels on the card) -> SDP duration loss -> prior
    expansion -> random slice (one offset per half-batch) -> hierarchical
    decode -> yingram of the output.
  * ``infer``: ``infer_pre_decoder`` (text encoder, SDP reverse,
    ``_expand_and_flow``) then ``infer_decode_chunk``.

Inputs and outputs keep the JAX layout (``[B, T, C]``, masks ``[B, T, 1]``);
the submodules run NCL. Every random site takes its noise from ``noise`` (a
dict, JAX layout) or draws it from ``generator``:

  forward: ``eps_spec`` [B, T_y, spec_ch], ``eps_yin`` [B, T_y, yin_ch]
           (posterior samples), ``scope_shift`` [B] int (yin decoder shift),
           ``e_q`` [B, T_x, 2] (SDP posterior noise), ``slice_u`` [B]
           (uniform slice offsets)
  infer:   ``sdp_noise`` [B, T_x, 2] (SDP reverse noise, before
           ``noise_scale_w``), ``eps`` [B, max_frames, inter] (prior sample)

Dropout follows ``train()``/``eval()``, as the JAX ``deterministic`` flag.

``bf16=True`` is the JAX package's compute policy: the two posterior
encoders' WaveNet stacks and the HiFi-GAN decoder compute in bfloat16;
parameters, stats, flows, MAS, the duration predictor, sampling and every
loss-facing tensor stay f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from vits_torch.config import HParams, synthesizer_kwargs
from vits_torch.models.duration import StochasticDurationPredictor
from vits_torch.models.flows import ResidualCouplingBlock
from vits_torch.models.hifigan import HiFiGANGenerator
from vits_torch.models.modules import embedding
from vits_torch.models.posterior_encoder import PosteriorEncoder
from vits_torch.models.text_encoder import TextEncoder
from vits_torch.models.ying_decoder import YingDecoder
from vits_torch.ops.commons import (
    crop_scope,
    dynamic_start,
    generate_path,
    rand_slice_segments_for_cat,
    sequence_mask,
)
from vits_torch.ops.mas import maximum_path
from vits_torch.ops.yin import Yingram
from vits_torch.text.symbols import symbols


# the draws of one ``forward`` (see the module docstring)
FORWARD_NOISE = ("eps_spec", "eps_yin", "scope_shift", "e_q", "slice_u")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vits_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class SynthesizerTrn(nn.Module):
    def __init__(
        self,
        num_chars,
        spec_channels,
        segment_size,
        midi_start,
        midi_end,
        octave_range,
        inter_channels,
        hidden_channels,
        filter_channels,
        n_heads,
        n_layers,
        kernel_size,
        p_dropout,
        resblock,
        resblock_kernel_sizes,
        resblock_dilation_sizes,
        upsample_rates,
        upsample_initial_channel,
        upsample_kernel_sizes,
        yin_channels,
        yin_start,
        yin_scope,
        yin_shift_range,
        n_speakers=0,
        gin_channels=0,
        sampling_rate=22050,
        filter_length=1024,
        hop_length=256,
        posterior_layers=16,
        flow_n_flows=4,
        flow_wn_layers=4,
        dur_n_flows=4,
        yin_dec_layers=4,
        bf16=False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.segment_size = segment_size
        self.inter_channels = inter_channels
        self.yin_channels = yin_channels
        self.yin_start = yin_start
        self.yin_scope = yin_scope
        self.n_speakers = n_speakers
        self.filter_length = filter_length
        self.hop_length = hop_length
        spec_ch = inter_channels - yin_channels

        self.text_encoder = TextEncoder(
            num_chars, inter_channels, hidden_channels, filter_channels, n_heads,
            n_layers, kernel_size, p_dropout,
        )
        self.waveform_decoder = HiFiGANGenerator(
            spec_ch + yin_scope, resblock, resblock_kernel_sizes,
            resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
            upsample_kernel_sizes, gin_channels=gin_channels, bf16=bf16,
        )
        self.posterior_encoder = PosteriorEncoder(
            spec_channels, spec_ch, spec_ch, 5, 1, posterior_layers,
            gin_channels=gin_channels, bf16=bf16,
        )
        self.pitch_encoder = PosteriorEncoder(
            yin_channels, yin_channels, yin_channels, 5, 1, posterior_layers,
            gin_channels=gin_channels, bf16=bf16,
        )
        self.flow = ResidualCouplingBlock(
            inter_channels, hidden_channels, 5, 1, flow_wn_layers, n_flows=flow_n_flows,
            gin_channels=gin_channels,
        )
        self.duration_predictor = StochasticDurationPredictor(
            hidden_channels, 192, 3, 0.5, dur_n_flows, gin_channels=gin_channels
        )
        self.yin_decoder = YingDecoder(
            yin_scope, 5, 1, yin_dec_layers, yin_start, yin_scope, yin_shift_range,
            gin_channels=gin_channels,
        )
        if n_speakers > 0:
            self.emb_g = embedding(n_speakers, gin_channels)
        self.pitch = Yingram(
            sr=sampling_rate, w_step=hop_length, w_size=2048, tau_max=2048,
            midi_start=midi_start, midi_end=midi_end, octave_range=octave_range,
        )
        self.to(device)

    # -- helpers ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.text_encoder.proj.weight.device

    def _speaker_embedding(self, sid):
        if self.n_speakers > 0:
            return self.emb_g(sid).unsqueeze(-1)  # [B, gin, 1]
        return None

    def _crop0(self, x, scope_shift=0, dim=1):
        """Scope crop of channels ``yin_start + scope_shift`` onwards, the
        start placed as ``jax.lax.dynamic_slice`` places it."""
        start = dynamic_start(self.yin_start + int(scope_shift), self.yin_scope, x.shape[dim])
        return x.narrow(dim, start, self.yin_scope)

    def _yingram_of(self, o):
        """Yingram of generated audio [2B, T, 1] with the reference padding:
        left filter_length - hop, right the same plus the round-up."""
        o = o[..., 0]
        length = o.shape[-1]
        left = self.filter_length - self.hop_length
        right = (
            left
            + (-length) % self.hop_length
            + self.hop_length * (length % self.hop_length == 0)
        )
        return self.pitch(F.pad(o, (left, right)))  # [2B, T', M]

    def _noise(self, noise, name, shape, generator, kind="normal"):
        """noise[name] moved to the model's device (JAX layout), or a draw."""
        if noise is not None and name in noise:
            v = torch.as_tensor(noise[name], device=self.device)
            if tuple(v.shape) != tuple(shape):
                raise ValueError(f"noise[{name!r}] has shape {tuple(v.shape)}, want {shape}")
            return v
        draw = torch.randn if kind == "normal" else torch.rand
        return draw(shape, generator=generator, device=self.device)

    def draw_noise(self, b: int, t_x: int, t_y: int, generator=None) -> dict:
        """Every draw of one ``forward`` at batch b, up front (JAX layout):
        what ``forward(noise=...)`` takes, so that a replay of the forward
        (``torch.utils.checkpoint``) sees the same numbers."""
        spec_ch = self.inter_channels - self.yin_channels
        return {
            "eps_spec": self._noise(None, "", (b, t_y, spec_ch), generator),
            "eps_yin": self._noise(None, "", (b, t_y, self.yin_channels), generator),
            "scope_shift": self.yin_decoder.draw_shift(b, generator, self.device),
            "e_q": self._noise(None, "", (b, t_x, 2), generator),
            "slice_u": self._noise(None, "", (b,), generator, kind="uniform"),
        }

    # -- training forward ------------------------------------------------

    def forward(
        self, x, t, x_lengths, y, y_lengths, ying, sid=None, *, noise=None,
        generator=None, scope_shift: int = 0,
    ) -> dict:
        """x, t: [B, T_x] symbol / language ids; x_lengths: [B]; y: [B, T_y,
        spec] linear spectrogram; y_lengths: [B]; ying: [B, T_y, yin]; sid:
        [B]. Returns the JAX ``__call__`` dict, every tensor channels-last."""
        b, t_x = x.shape
        t_y = y.shape[1]
        spec_ch = self.inter_channels - self.yin_channels

        x_h, m_p, logs_p, x_mask = self.text_encoder(x, t, x_lengths)
        g = self._speaker_embedding(sid)

        eps_spec = self._noise(noise, "eps_spec", (b, t_y, spec_ch), generator)
        z_spec, m_spec, logs_spec, spec_mask = self.posterior_encoder(
            y.transpose(1, 2), y_lengths, g=g, eps=eps_spec.transpose(1, 2)
        )
        eps_yin = self._noise(noise, "eps_yin", (b, t_y, self.yin_channels), generator)
        ying_ncl = ying.transpose(1, 2)
        z_yin, m_yin, logs_yin, yin_mask = self.pitch_encoder(
            ying_ncl, y_lengths, g=g, eps=eps_yin.transpose(1, 2)
        )
        z_yin_crop = self._crop0(z_yin, scope_shift)

        if noise is not None and "scope_shift" in noise:
            shift = torch.as_tensor(noise["scope_shift"], device=self.device)
        else:
            shift = self.yin_decoder.draw_shift(b, generator, self.device)
        (
            yin_gt_crop,
            yin_gt_shifted_crop,
            yin_dec_crop,
            z_yin_crop_shifted,
            shift,
        ) = self.yin_decoder(z_yin, ying_ncl, yin_mask, g, shift)

        z = torch.cat([z_spec, z_yin], dim=1)
        logs_q = torch.cat([logs_spec, logs_yin], dim=1)
        m_q = torch.cat([m_spec, m_yin], dim=1)
        z_p = self.flow(z, spec_mask, g=g)

        z_dec = torch.cat([z_spec, z_yin_crop], dim=1)
        z_dec_shifted = torch.cat([z_spec.detach(), z_yin_crop_shifted], dim=1)
        z_dec_ = torch.cat([z_dec, z_dec_shifted], dim=0)  # [2B, C, T_y]

        # -- MAS, no gradient -------------------------------------------
        with torch.no_grad():
            s_p_sq_r = torch.exp(-2.0 * logs_p)  # [B, C, T_x]
            neg_cent1 = torch.sum(
                -0.5 * math.log(2 * math.pi) - logs_p, dim=1, keepdim=True
            )  # [B, 1, T_x]
            neg_cent2 = torch.matmul(-0.5 * (z_p**2).transpose(1, 2), s_p_sq_r)
            neg_cent3 = torch.matmul(z_p.transpose(1, 2), m_p * s_p_sq_r)
            neg_cent4 = torch.sum(-0.5 * m_p**2 * s_p_sq_r, dim=1, keepdim=True)
            neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4  # [B, T_y, T_x]
            attn_mask = spec_mask.transpose(1, 2) * x_mask  # [B, T_y, T_x]
            attn = maximum_path(neg_cent, attn_mask)

        # -- duration loss -----------------------------------------------
        w = attn.sum(dim=1).unsqueeze(1)  # [B, 1, T_x]
        e_q = self._noise(noise, "e_q", (b, t_x, 2), generator)
        l_length = self.duration_predictor(x_h, x_mask, w, g=g, e_q=e_q.transpose(1, 2))
        l_length = l_length / torch.sum(x_mask)

        # -- expand prior (channels-last) ---------------------------------
        m_p_exp = torch.matmul(attn, m_p.transpose(1, 2))
        logs_p_exp = torch.matmul(attn, logs_p.transpose(1, 2))

        # -- random segment + hierarchical decode --------------------------
        slice_u = self._noise(noise, "slice_u", (b,), generator, kind="uniform")
        z_slice, ids_slice = rand_slice_segments_for_cat(
            z_dec_.transpose(1, 2),
            torch.cat([y_lengths, y_lengths], dim=0),
            self.segment_size // self.hop_length,
            slice_u,
        )
        g2 = torch.cat([g, g], dim=0) if g is not None else None
        o_ = self.waveform_decoder.hier_forward(z_slice.transpose(1, 2), g=g2)
        o_ = [o.transpose(1, 2) for o in o_]  # 3 x [2B, T_i, 1]

        # -- yingram of the generated audio --------------------------------
        yin_hat = self._yingram_of(o_[-1])  # [2B, T', M]
        yin_hat_crop = self._crop0(yin_hat, dim=2)
        yin_hat_shifted = crop_scope(yin_hat[:b], self.yin_start, self.yin_scope, shift)

        def cl(v):
            return v.transpose(1, 2)

        return {
            "wav_hier": o_,
            "l_length": l_length,
            "attn": attn,
            "ids_slice": ids_slice,
            "x_mask": cl(x_mask),
            "z_mask": cl(spec_mask),
            "z": cl(z),
            "z_p": cl(z_p),
            "m_p": m_p_exp,
            "logs_p": logs_p_exp,
            "m_q": cl(m_q),
            "logs_q": cl(logs_q),
            "z_dec": cl(z_dec_),
            "z_spec": cl(z_spec),
            "m_spec": cl(m_spec),
            "logs_spec": cl(logs_spec),
            "z_yin": cl(z_yin),
            "m_yin": cl(m_yin),
            "logs_yin": cl(logs_yin),
            "yin_gt_crop": cl(yin_gt_crop),
            "yin_gt_shifted_crop": cl(yin_gt_shifted_crop),
            "yin_dec_crop": cl(yin_dec_crop),
            "yin_hat_crop": yin_hat_crop,
            "scope_shift": shift,
            "yin_hat_shifted": yin_hat_shifted,
        }

    # -- inference -------------------------------------------------------

    def _pre_decoder(
        self, x, t, x_lengths, sid, noise, generator, noise_scale, length_scale,
        noise_scale_w, max_frames, scope_shift,
    ):
        """``infer_pre_decoder`` with NCL decoder inputs and mask."""
        b, t_x = x.shape
        x_h, m_p, logs_p, x_mask = self.text_encoder(x, t, x_lengths)
        g = self._speaker_embedding(sid)
        z = self._noise(noise, "sdp_noise", (b, t_x, 2), generator)
        logw = self.duration_predictor.reverse(
            x_h, x_mask, g=g, z=z.transpose(1, 2), noise_scale=noise_scale_w
        )
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1).to(torch.int32)
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        eps = self._noise(noise, "eps", (b, max_frames, self.inter_channels), generator)
        decoder_inputs, y_mask, aux = self._expand_and_flow(
            w_ceil[:, 0], m_p, logs_p, x_mask, g, eps.transpose(1, 2), noise_scale,
            max_frames, scope_shift,
        )
        return decoder_inputs, y_mask, y_lengths, aux, g

    def _expand_and_flow(
        self, w_ceil, m_p, logs_p, x_mask, g, eps, noise_scale, max_frames, scope_shift
    ):
        """Length-regulate + reverse flow + scope crop. NCL in and out:
        w_ceil [B, T_x]; m_p, logs_p [B, C, T_x]; eps [B, C, max_frames]."""
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), min=1).to(torch.int32)
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames).unsqueeze(1).to(m_p.dtype)
        attn_mask = y_mask.transpose(1, 2) * x_mask  # [B, T_y, T_x]
        attn = generate_path(w_ceil, attn_mask)
        m_p_exp = torch.matmul(attn, m_p.transpose(1, 2)).transpose(1, 2)
        logs_p_exp = torch.matmul(attn, logs_p.transpose(1, 2)).transpose(1, 2)
        z_p = m_p_exp + eps * torch.exp(logs_p_exp) * noise_scale
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        spec_ch = self.inter_channels - self.yin_channels
        z_spec, z_yin = z[:, :spec_ch], z[:, spec_ch:]
        z_crop = torch.cat([z_spec, self._crop0(z_yin, scope_shift)], dim=1)
        return z_crop * y_mask, y_mask, (z_crop, z, z_p, m_p_exp, logs_p_exp)

    def infer_pre_decoder(
        self, x, t, x_lengths, sid=None, *, noise=None, generator=None,
        noise_scale: float = 1.0, length_scale: float = 1.0,
        noise_scale_w: float = 1.0, max_frames: int = 2000, scope_shift: int = 0,
    ):
        """Text -> decoder inputs [B, max_frames, C], y_mask [B, max_frames, 1],
        y_lengths [B], aux (channels-last)."""
        dec_in, y_mask, y_lengths, aux, _ = self._pre_decoder(
            x, t, x_lengths, sid, noise, generator, noise_scale, length_scale,
            noise_scale_w, max_frames, scope_shift,
        )
        aux = tuple(a.transpose(1, 2) for a in aux)
        return dec_in.transpose(1, 2), y_mask.transpose(1, 2), y_lengths, aux

    def infer_decode_chunk(self, decoder_inputs, sid=None):
        """Decoder only: [B, T, C] -> waveform [B, T * hop, 1]."""
        g = self._speaker_embedding(sid)
        return self.waveform_decoder(decoder_inputs.transpose(1, 2), g=g).transpose(1, 2)

    def infer(
        self, x, t, x_lengths, sid=None, *, noise=None, generator=None,
        noise_scale: float = 0.667, length_scale: float = 1.0,
        noise_scale_w: float = 0.8, max_frames: int = 2000, scope_shift: int = 0,
    ):
        """Text -> (waveform [B, max_frames * hop, 1], y_mask [B, max_frames,
        1], y_lengths [B])."""
        dec_in, y_mask, y_lengths, _, g = self._pre_decoder(
            x, t, x_lengths, sid, noise, generator, noise_scale, length_scale,
            noise_scale_w, max_frames, scope_shift,
        )
        wav = self.waveform_decoder(dec_in, g=g)
        return wav.transpose(1, 2), y_mask.transpose(1, 2), y_lengths


def build_synthesizer(
    hps: HParams, device=None, num_chars: int | None = None, bf16: bool = False
):
    """The generator of a config (``configs/*.yaml``) with fresh weights, on
    ``cuda`` unless ``device`` says otherwise."""
    kwargs = synthesizer_kwargs(hps, num_chars or len(symbols))
    return SynthesizerTrn(**kwargs, bf16=bf16, device=resolve_device(device))
