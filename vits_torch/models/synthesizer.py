"""SynthesizerTrn: conditional VAE + flow + hierarchical HiFi-GAN generator
with PITS yingram pitch control (port of ``vits_tpu/models/synthesizer.py``).

Every entry point of the JAX model is ported here:
  * ``forward`` (JAX ``__call__``): the generator's training forward. Text
    encoder -> spec and pitch posteriors -> flow -> neg-cross-entropy lattice
    -> MAS (the CUDA kernels on the card) -> SDP duration loss -> prior
    expansion -> random slice (one offset per half-batch) -> hierarchical
    decode -> yingram of the output.
  * ``infer``: ``infer_pre_decoder`` (text encoder, SDP reverse,
    ``_expand_and_flow``) then ``infer_decode_chunk``; on the card, replayed
    from the serving engine's CUDA graphs (``infer_graphs``) where it sets them,
    in two stages: ``_infer_text`` (to the predicted lengths and the expanded
    prior) and ``_infer_frames`` (the rest, at the frames the rows need).
  * the staged latency-control API: ``infer_pre_lr`` (text encoder, SDP
    reverse), ``infer_lr`` (length regulation), ``infer_post_lr_pre_decoder``
    (prior sample, reverse flow, scope crop), then ``infer_decode_chunk``.
  * ``yin_dec_infer`` (the yin decoder at a random shift, for evaluation) and
    ``voice_conversion`` (both posteriors through the flow to the target
    speaker, scope-cropped decoder input).

Inputs and outputs keep the JAX layout (``[B, T, C]``, masks ``[B, T, 1]``);
the submodules run NCL. Every random site takes its noise from ``noise`` (a
dict, JAX layout) or draws it from ``generator``, in the order listed:

  forward:          ``eps_spec`` [B, T_y, spec_ch], ``eps_yin`` [B, T_y,
                    yin_ch] (posterior samples), ``scope_shift`` [B] int (yin
                    decoder shift), ``e_q`` [B, T_x, 2] (SDP posterior
                    noise), ``slice_u`` [B] (uniform slice offsets); without
                    the pitch path ``eps_spec`` [B, T_y, inter], ``e_q``,
                    ``slice_u`` (``PITCHLESS_NOISE``)
  infer:            ``sdp_noise`` [B, T_x, 2] (SDP reverse noise, before
                    ``noise_scale_w``), ``eps`` [B, max_frames, inter] (prior
                    sample)
  infer_pre_lr:     ``sdp_noise``
  infer_post_lr_pre_decoder: ``eps`` [B, T_y, inter]
  yin_dec_infer:    ``scope_shift`` [B] int
  voice_conversion: ``eps_spec``, ``eps_yin`` (as in forward)

``infer`` and ``infer_pre_decoder`` also take one ``length_scale`` and one
``scope_shift`` a row ([B] tensors), as the JAX engine's vmapped batch gives
each request its own.

Dropout follows ``train()``/``eval()``, as the JAX ``deterministic`` flag.

``bf16=True`` is the JAX package's compute policy: the two posterior
encoders' WaveNet stacks and the HiFi-GAN decoder compute in bfloat16;
parameters, stats, flows, MAS, the duration predictor, sampling and every
loss-facing tensor stay f32.

Other models of the VITS family, by three switches whose defaults build the
model above: ``decoder="mb_istft"`` (MB-iSTFT-VITS's multi-band iSTFT
generator, ``models/istft_generator.py``, with ``subbands``,
``gen_istft_n_fft`` and ``gen_istft_hop_size``), ``pitch="none"`` (no pitch
posterior, yin decoder or Yingram: the decoder takes all of z and
``scope_shift`` is unread) and ``language_embedding=False`` (no ``emb_t``).
A pitchless model serves (``infer``, the staged API, ``infer_decode_chunk``)
and, with the multi-band iSTFT decoder, trains: its ``forward`` is
MB-iSTFT-VITS's ``SynthesizerTrn.forward`` (text encoder -> posterior encoder
over all of z -> flow -> the same lattice and MAS -> SDP loss -> prior
expansion -> one random slice a row, B rows -> the decoder's
``train_forward``, which also returns the sub-band signals). A model with the
pitch path trains the HiFi-GAN decoder (``hier_forward``); ``yin_dec_infer``
and ``voice_conversion`` need the pitch path. Elsewhere they raise.

Spans (``utils/profiling.py``): ``vits.decode`` around the decoder call of
``infer`` and ``infer_decode_chunk``.
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
from vits_torch.models.istft_generator import MultiBandISTFTGenerator
from vits_torch.models.modules import embedding
from vits_torch.models.posterior_encoder import PosteriorEncoder
from vits_torch.models.text_encoder import TextEncoder
from vits_torch.models.ying_decoder import YingDecoder, crop_channels
from vits_torch.ops.commons import (
    crop_scope,
    dynamic_start,
    generate_path,
    rand_slice_segments,
    rand_slice_segments_for_cat,
    sequence_mask,
)
from vits_torch.ops.mas import maximum_path
from vits_torch.ops.yin import Yingram
from vits_torch.text.symbols import symbols
from vits_torch.utils.profiling import span


# the draws of one ``forward`` (see the module docstring), with and without
# the pitch path
FORWARD_NOISE = ("eps_spec", "eps_yin", "scope_shift", "e_q", "slice_u")
PITCHLESS_NOISE = ("eps_spec", "e_q", "slice_u")


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
    # the serving engine's graph cache (``serve/graphs.py::InferGraphs``);
    # None, the default, runs every ``infer`` eagerly
    infer_graphs = None

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
        decoder="hifigan",
        subbands=4,
        gen_istft_n_fft=16,
        gen_istft_hop_size=4,
        pitch="yingram",
        language_embedding=True,
        bf16=False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        if decoder not in ("hifigan", "mb_istft") or pitch not in ("yingram", "none"):
            raise ValueError(f"unknown decoder {decoder!r} or pitch {pitch!r}: decoder is "
                             "'hifigan' or 'mb_istft', pitch 'yingram' or 'none'")
        self.decoder = decoder
        self.has_pitch = pitch != "none"
        self.forward_noise = FORWARD_NOISE if self.has_pitch else PITCHLESS_NOISE
        if not self.has_pitch:
            yin_channels = yin_scope = 0
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
            n_layers, kernel_size, p_dropout, language_embedding=language_embedding,
        )
        if decoder == "hifigan":
            self.waveform_decoder = HiFiGANGenerator(
                spec_ch + yin_scope, resblock, resblock_kernel_sizes,
                resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
                upsample_kernel_sizes, gin_channels=gin_channels, bf16=bf16,
            )
        else:
            self.waveform_decoder = MultiBandISTFTGenerator(
                spec_ch + yin_scope, resblock_kernel_sizes, resblock_dilation_sizes,
                upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
                subbands, gen_istft_n_fft, gen_istft_hop_size, gin_channels=gin_channels,
                bf16=bf16,
            )
        # PITS's spec posterior is as wide as its share of z; VITS's (no
        # pitch) has the model's hidden width
        self.posterior_encoder = PosteriorEncoder(
            spec_channels, spec_ch, spec_ch if self.has_pitch else hidden_channels, 5, 1,
            posterior_layers, gin_channels=gin_channels, bf16=bf16,
        )
        if self.has_pitch:
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
        if self.has_pitch:
            self.yin_decoder = YingDecoder(
                yin_scope, 5, 1, yin_dec_layers, yin_start, yin_scope, yin_shift_range,
                gin_channels=gin_channels,
            )
            self.pitch = Yingram(
                sr=sampling_rate, w_step=hop_length, w_size=2048, tau_max=2048,
                midi_start=midi_start, midi_end=midi_end, octave_range=octave_range,
            )
        if n_speakers > 0:
            self.emb_g = embedding(n_speakers, gin_channels)
        self.to(device)

    # -- helpers ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.text_encoder.proj.weight.device

    def _speaker_embedding(self, sid):
        if self.n_speakers > 0:
            return self.emb_g(sid).unsqueeze(-1)  # [B, gin, 1]
        return None

    def _needs_pitch(self, what: str) -> None:
        """Raises where ``what`` needs the pitch path and this model has none."""
        if not self.has_pitch:
            raise ValueError(f"{what} needs the pitch path; this model has none (pitch: none)")

    def _trains(self, what: str) -> None:
        """Raises where this model has no training forward: the pitch path
        trains the HiFi-GAN decoder (``hier_forward``), a pitchless model the
        multi-band iSTFT one (``train_forward``)."""
        want = "hifigan" if self.has_pitch else "mb_istft"
        if self.decoder != want:
            kind = "HiFi-GAN" if self.has_pitch else "multi-band iSTFT"
            raise ValueError(f"{what} of a model with pitch {'yingram' if self.has_pitch else 'none'}"
                             f" trains the {kind} decoder; this model's decoder is "
                             f"{self.decoder!r}")

    def _crop0(self, x, scope_shift=0, dim=1):
        """Scope crop of channels ``yin_start + scope_shift`` onwards, the
        start placed as ``jax.lax.dynamic_slice`` places it; a [B] tensor
        shift crops each row of an NCL tensor at its own."""
        if isinstance(scope_shift, torch.Tensor) and scope_shift.ndim == 1:
            return crop_channels(x, self.yin_start, self.yin_scope, scope_shift.to(x.device))
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
        self._trains("draw_noise")
        if not self.has_pitch:
            return {
                "eps_spec": self._noise(None, "", (b, t_y, self.inter_channels), generator),
                "e_q": self._noise(None, "", (b, t_x, 2), generator),
                "slice_u": self._noise(None, "", (b,), generator, kind="uniform"),
            }
        spec_ch = self.inter_channels - self.yin_channels
        return {
            "eps_spec": self._noise(None, "", (b, t_y, spec_ch), generator),
            "eps_yin": self._noise(None, "", (b, t_y, self.yin_channels), generator),
            "scope_shift": self.yin_decoder.draw_shift(b, generator, self.device),
            "e_q": self._noise(None, "", (b, t_x, 2), generator),
            "slice_u": self._noise(None, "", (b,), generator, kind="uniform"),
        }

    def _align(self, z_p, m_p, logs_p, spec_mask, x_mask):
        """The neg-cross-entropy lattice of z_p [B, C, T_y] under the prior
        (m_p, logs_p [B, C, T_x]) and its monotonic path (MAS), no gradient:
        attn [B, T_y, T_x]."""
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
            return maximum_path(neg_cent, attn_mask)

    def _duration_and_prior(self, attn, x_h, m_p, logs_p, x_mask, g, e_q, x_mask_total):
        """SDP loss over the path's durations and the prior expanded over the
        frames (channels-last): (l_length [B], m_p_exp, logs_p_exp [B, T_y, C])."""
        w = attn.sum(dim=1).unsqueeze(1)  # [B, 1, T_x]
        l_length = self.duration_predictor(x_h, x_mask, w, g=g, e_q=e_q.transpose(1, 2))
        l_length = l_length / (torch.sum(x_mask) if x_mask_total is None else x_mask_total)
        m_p_exp = torch.matmul(attn, m_p.transpose(1, 2))
        logs_p_exp = torch.matmul(attn, logs_p.transpose(1, 2))
        return l_length, m_p_exp, logs_p_exp

    # -- training forward ------------------------------------------------

    def forward(
        self, x, t, x_lengths, y, y_lengths, ying, sid=None, *, noise=None,
        generator=None, scope_shift: int = 0, x_mask_total=None,
    ) -> dict:
        """x, t: [B, T_x] symbol / language ids; x_lengths: [B]; y: [B, T_y,
        spec] linear spectrogram; y_lengths: [B]; ying: [B, T_y, yin] (unread,
        and may be None, without the pitch path: ``_forward_pitchless``); sid:
        [B]. Returns the JAX ``__call__`` dict, every tensor channels-last.
        ``l_length`` is divided by ``x_mask_total`` where it is given (a
        data-parallel step's shared denominator), else by ``sum(x_mask)``."""
        self._trains("forward")
        if not self.has_pitch:
            return self._forward_pitchless(x, t, x_lengths, y, y_lengths, sid, noise, generator,
                                           x_mask_total)
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

        attn = self._align(z_p, m_p, logs_p, spec_mask, x_mask)
        e_q = self._noise(noise, "e_q", (b, t_x, 2), generator)
        l_length, m_p_exp, logs_p_exp = self._duration_and_prior(
            attn, x_h, m_p, logs_p, x_mask, g, e_q, x_mask_total)

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

    def _forward_pitchless(self, x, t, x_lengths, y, y_lengths, sid, noise, generator,
                           x_mask_total) -> dict:
        """``forward`` of a model without the pitch path (MB-iSTFT-VITS's
        order, B rows): the posterior encoder over all ``inter_channels``,
        the flow, the lattice and MAS, the SDP loss, the prior expansion, one
        random slice a row of ``segment_size // hop`` frames of z, and the
        decoder's ``train_forward``. Returns ``wav`` [B, segment, 1] and
        ``wav_bands`` [B, segment / subbands, subbands] beside the keys the
        KL, duration and mel losses read, channels-last."""
        b, t_x = x.shape
        t_y = y.shape[1]
        x_h, m_p, logs_p, x_mask = self.text_encoder(x, t, x_lengths)
        g = self._speaker_embedding(sid)
        eps_spec = self._noise(noise, "eps_spec", (b, t_y, self.inter_channels), generator)
        z, m_q, logs_q, spec_mask = self.posterior_encoder(
            y.transpose(1, 2), y_lengths, g=g, eps=eps_spec.transpose(1, 2))
        z_p = self.flow(z, spec_mask, g=g)
        attn = self._align(z_p, m_p, logs_p, spec_mask, x_mask)
        e_q = self._noise(noise, "e_q", (b, t_x, 2), generator)
        l_length, m_p_exp, logs_p_exp = self._duration_and_prior(
            attn, x_h, m_p, logs_p, x_mask, g, e_q, x_mask_total)
        slice_u = self._noise(noise, "slice_u", (b,), generator, kind="uniform")
        z_slice, ids_slice = rand_slice_segments(
            z.transpose(1, 2), y_lengths, self.segment_size // self.hop_length, slice_u)
        wav, bands = self.waveform_decoder.train_forward(z_slice.transpose(1, 2), g=g)

        def cl(v):
            return v.transpose(1, 2)

        return {
            "wav": cl(wav),
            "wav_bands": cl(bands),
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
        }

    # -- inference -------------------------------------------------------

    def _durations(self, x, t, x_lengths, sid, noise, generator, length_scale, noise_scale_w):
        """Text encoder + SDP reverse, NCL: (w_ceil [B, 1, T_x], x_h, m_p,
        logs_p, x_mask, g). ``length_scale``: a float or one a row ([B])."""
        b, t_x = x.shape
        x_h, m_p, logs_p, x_mask = self.text_encoder(x, t, x_lengths)
        g = self._speaker_embedding(sid)
        z = self._noise(noise, "sdp_noise", (b, t_x, 2), generator)
        logw = self.duration_predictor.reverse(
            x_h, x_mask, g=g, z=z.transpose(1, 2), noise_scale=noise_scale_w
        )
        if isinstance(length_scale, torch.Tensor):
            length_scale = length_scale.to(logw.device, logw.dtype).reshape(-1, 1, 1)
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        return w_ceil, x_h, m_p, logs_p, x_mask, g

    def _pre_decoder(
        self, x, t, x_lengths, sid, noise, generator, noise_scale, length_scale,
        noise_scale_w, max_frames, scope_shift,
    ):
        """``infer_pre_decoder`` with NCL decoder inputs and mask."""
        w_ceil, _, m_p, logs_p, x_mask, g = self._durations(
            x, t, x_lengths, sid, noise, generator, length_scale, noise_scale_w
        )
        y_lengths = self._lengths(w_ceil, max_frames)
        eps = self._noise(noise, "eps", (x.shape[0], max_frames, self.inter_channels), generator)
        decoder_inputs, y_mask, aux = self._expand_and_flow(
            w_ceil[:, 0], m_p, logs_p, x_mask, g, eps.transpose(1, 2), noise_scale,
            max_frames, scope_shift,
        )
        return decoder_inputs, y_mask, y_lengths, aux, g

    @staticmethod
    def _lengths(w_ceil, max_frames):
        """The predicted frames of each row, [B] int32: the sum of w_ceil
        [B, 1, T_x], at least 1 and at most ``max_frames``."""
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1).to(torch.int32)
        return torch.clamp(y_lengths, max=max_frames)

    def _length_regulate(self, w_ceil, m_p, logs_p, x_mask, max_frames):
        """Expand the prior over frames, NCL: w_ceil [B, T_x]; m_p, logs_p
        [B, C, T_x] -> (m_p_exp, logs_p_exp [B, C, max_frames], y_mask [B, 1,
        max_frames])."""
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), min=1).to(torch.int32)
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames).unsqueeze(1).to(m_p.dtype)
        attn_mask = y_mask.transpose(1, 2) * x_mask  # [B, T_y, T_x]
        attn = generate_path(w_ceil, attn_mask)
        m_p_exp = torch.matmul(attn, m_p.transpose(1, 2)).transpose(1, 2)
        logs_p_exp = torch.matmul(attn, logs_p.transpose(1, 2)).transpose(1, 2)
        return m_p_exp, logs_p_exp, y_mask

    def _flow_and_crop(self, m_p, logs_p, y_mask, g, eps, noise_scale, scope_shift):
        """Prior sample + reverse flow + scope crop, NCL in and out."""
        z_p = m_p + eps * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, y_mask, g=g, reverse=True)
        if self.has_pitch:
            spec_ch = self.inter_channels - self.yin_channels
            z_spec, z_yin = z[:, :spec_ch], z[:, spec_ch:]
            z_crop = torch.cat([z_spec, self._crop0(z_yin, scope_shift)], dim=1)
        else:
            z_crop = z
        return z_crop * y_mask, y_mask, (z_crop, z, z_p, m_p, logs_p)

    def _expand_and_flow(
        self, w_ceil, m_p, logs_p, x_mask, g, eps, noise_scale, max_frames, scope_shift
    ):
        """Length-regulate + reverse flow + scope crop. NCL in and out:
        w_ceil [B, T_x]; m_p, logs_p [B, C, T_x]; eps [B, C, max_frames]."""
        m_p_exp, logs_p_exp, y_mask = self._length_regulate(w_ceil, m_p, logs_p, x_mask, max_frames)
        return self._flow_and_crop(m_p_exp, logs_p_exp, y_mask, g, eps, noise_scale, scope_shift)

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
        with span("decode"):
            return self.waveform_decoder(decoder_inputs.transpose(1, 2), g=g).transpose(1, 2)

    def infer(
        self, x, t, x_lengths, sid=None, *, noise=None, generator=None,
        noise_scale: float = 0.667, length_scale: float = 1.0,
        noise_scale_w: float = 0.8, max_frames: int = 2000, scope_shift: int = 0,
    ):
        """Text -> (waveform [B, max_frames * hop, 1], y_mask [B, max_frames,
        1], y_lengths [B]). With ``infer_graphs`` set, a call it takes is
        replayed from CUDA graphs of its two stages and decodes F <=
        ``max_frames`` frames, the fewest of its ladder that hold every row's
        predicted length (``serve/graphs.py``): the waveform is [B, F * hop,
        1] and y_mask [B, F, 1]."""
        graphs = self.infer_graphs
        if graphs is not None and graphs.takes(x, noise, generator, length_scale, scope_shift):
            return graphs(self, x, t, x_lengths, sid, noise, length_scale, scope_shift,
                          noise_scale=noise_scale, noise_scale_w=noise_scale_w,
                          max_frames=max_frames)
        return self._infer(
            x, t, x_lengths, sid, noise=noise, generator=generator, noise_scale=noise_scale,
            length_scale=length_scale, noise_scale_w=noise_scale_w, max_frames=max_frames,
            scope_shift=scope_shift,
        )

    def _infer(
        self, x, t, x_lengths, sid, *, noise, noise_scale, length_scale, noise_scale_w,
        max_frames, scope_shift, generator=None,
    ):
        dec_in, y_mask, y_lengths, _, g = self._pre_decoder(
            x, t, x_lengths, sid, noise, generator, noise_scale, length_scale,
            noise_scale_w, max_frames, scope_shift,
        )
        with span("decode"):
            wav = self.waveform_decoder(dec_in, g=g)
        return wav.transpose(1, 2), y_mask.transpose(1, 2), y_lengths

    def _infer_text(self, x, t, x_lengths, sid, sdp_noise, length_scale, *, noise_scale_w,
                    max_frames):
        """The first stage of a sized call (``serve/graphs.py``): text
        encoder, SDP reverse on ``sdp_noise`` [B, T_x, 2], the predicted
        lengths and the prior expanded over ``max_frames`` -> (m_p, logs_p
        [B, max_frames, C], y_lengths [B] int32, g [B, gin, 1] or None)."""
        w_ceil, _, m_p, logs_p, x_mask, g = self._durations(
            x, t, x_lengths, sid, {"sdp_noise": sdp_noise}, None, length_scale, noise_scale_w
        )
        m_p_exp, logs_p_exp, _ = self._length_regulate(
            w_ceil[:, 0], m_p, logs_p, x_mask, max_frames)
        return (m_p_exp.transpose(1, 2), logs_p_exp.transpose(1, 2),
                self._lengths(w_ceil, max_frames), g)

    def _infer_frames(self, m_p, logs_p, y_lengths, g, eps, scope_shift, *, noise_scale):
        """The second stage at F = ``m_p.shape[1]`` frames, F at least every
        row's length: prior sample on ``eps`` [B, F, C], reverse flow, scope
        crop, decoder -> (waveform [B, F * hop, 1], y_mask [B, F, 1]). On
        ``_infer_text``'s outputs cut to their first F frames it is ``_infer``
        at ``max_frames`` F, bit for bit: a frame of the expanded prior is one
        token's row of m_p or logs_p, or zeros, at any ``max_frames``."""
        y_mask = sequence_mask(y_lengths, m_p.shape[1]).unsqueeze(1).to(m_p.dtype)
        dec_in, _, _ = self._flow_and_crop(
            m_p.transpose(1, 2), logs_p.transpose(1, 2), y_mask, g, eps.transpose(1, 2),
            noise_scale, scope_shift,
        )
        with span("decode"):
            wav = self.waveform_decoder(dec_in, g=g)
        return wav.transpose(1, 2), y_mask.transpose(1, 2)

    # -- staged latency-control API ----------------------------------------

    def infer_pre_lr(
        self, x, t, x_lengths, sid=None, *, noise=None, generator=None,
        length_scale: float = 1.0, noise_scale_w: float = 1.0,
    ):
        """Text encoder + SDP reverse -> (w_ceil [B, T_x, 1], x_h [B, T_x,
        H], m_p, logs_p [B, T_x, C], x_mask [B, T_x, 1], g [B, 1, gin] or
        None)."""
        out = self._durations(x, t, x_lengths, sid, noise, generator, length_scale, noise_scale_w)
        return tuple(None if a is None else a.transpose(1, 2) for a in out)

    def infer_lr(self, w_ceil, m_p, logs_p, x_mask, max_frames: int = 2000):
        """Length regulation, channels-last: w_ceil [B, T_x, 1] -> (m_p_exp,
        logs_p_exp [B, max_frames, C], y_mask [B, max_frames, 1])."""
        out = self._length_regulate(
            w_ceil[..., 0], m_p.transpose(1, 2), logs_p.transpose(1, 2),
            x_mask.transpose(1, 2), max_frames,
        )
        return tuple(a.transpose(1, 2) for a in out)

    def infer_post_lr_pre_decoder(
        self, m_p, logs_p, g, y_mask, *, noise=None, generator=None,
        noise_scale: float = 1.0, scope_shift: int = 0,
    ):
        """Prior sample + reverse flow + scope crop, channels-last: m_p,
        logs_p [B, T_y, C], g [B, 1, gin] or None, y_mask [B, T_y, 1] ->
        (decoder inputs [B, T_y, C_dec], y_mask, (z_crop, z, z_p, m_p,
        logs_p))."""
        b, t_y, _ = m_p.shape
        eps = self._noise(noise, "eps", (b, t_y, self.inter_channels), generator)
        dec_in, y_mask, aux = self._flow_and_crop(
            m_p.transpose(1, 2), logs_p.transpose(1, 2), y_mask.transpose(1, 2),
            None if g is None else g.transpose(1, 2), eps.transpose(1, 2), noise_scale,
            scope_shift,
        )
        return dec_in.transpose(1, 2), y_mask.transpose(1, 2), tuple(a.transpose(1, 2) for a in aux)

    # -- misc ------------------------------------------------------------

    def yin_dec_infer(self, z_yin, z_mask, sid=None, *, noise=None, generator=None):
        """Yin decoder reconstruction at a random scope shift (evaluation):
        z_yin [B, T, C_yin], z_mask [B, T, 1] -> [B, T, yin_scope]."""
        self._needs_pitch("yin_dec_infer")
        out = self.yin_decoder.infer(
            z_yin.transpose(1, 2), z_mask.transpose(1, 2), self._speaker_embedding(sid),
            shift=None if noise is None else noise.get("scope_shift"), generator=generator,
        )
        return out.transpose(1, 2)

    def voice_conversion(
        self, y, ying, y_lengths, sid_src, sid_tgt, *, noise=None, generator=None,
        scope_shift: int = 0,
    ):
        """Source speaker -> target speaker via the shared flow: both
        posteriors (spec + yin) feed the flow, the decoder input is
        scope-cropped as in inference. y: [B, T, spec]; ying: [B, T, yin] ->
        (waveform [B, T * hop, 1], y_mask [B, T, 1], (z, z_p, z_hat))."""
        self._needs_pitch("voice_conversion")
        if self.n_speakers <= 0:
            raise ValueError("voice conversion needs a multi-speaker model (n_speakers > 0)")
        b, t_y = y.shape[:2]
        spec_ch = self.inter_channels - self.yin_channels
        g_src = self._speaker_embedding(sid_src)
        g_tgt = self._speaker_embedding(sid_tgt)
        eps_spec = self._noise(noise, "eps_spec", (b, t_y, spec_ch), generator)
        z_spec, _, _, y_mask = self.posterior_encoder(
            y.transpose(1, 2), y_lengths, g=g_src, eps=eps_spec.transpose(1, 2)
        )
        eps_yin = self._noise(noise, "eps_yin", (b, t_y, self.yin_channels), generator)
        z_yin, _, _, _ = self.pitch_encoder(
            ying.transpose(1, 2), y_lengths, g=g_src, eps=eps_yin.transpose(1, 2)
        )
        z = torch.cat([z_spec, z_yin], dim=1)
        z_p = self.flow(z, y_mask, g=g_src)
        z_hat = self.flow(z_p, y_mask, g=g_tgt, reverse=True)
        z_crop = torch.cat([z_hat[:, :spec_ch], self._crop0(z_hat[:, spec_ch:], scope_shift)], dim=1)
        o_hat = self.waveform_decoder(z_crop * y_mask, g=g_tgt)
        return (
            o_hat.transpose(1, 2), y_mask.transpose(1, 2),
            (z.transpose(1, 2), z_p.transpose(1, 2), z_hat.transpose(1, 2)),
        )


def build_synthesizer(
    hps: HParams, device=None, num_chars: int | None = None, bf16: bool = False
):
    """The generator of a config (``configs/*.yaml``) with fresh weights, on
    ``cuda`` unless ``device`` says otherwise."""
    kwargs = synthesizer_kwargs(hps, num_chars or len(symbols))
    return SynthesizerTrn(**kwargs, bf16=bf16, device=resolve_device(device))
