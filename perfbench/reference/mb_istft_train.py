"""MB-iSTFT-VITS's training step written plainly: what the benchmark's
``ljs_mbistft.train`` cell and the port's tests hold ``vits_torch``'s
pitchless ``train_step`` to.

Kawamura, Shirahata, Yamamoto and Tachibana, ICASSP 2023, arXiv:2210.15975;
github.com/MasayaKawamura/MB-iSTFT-VITS ``models.py::SynthesizerTrn.forward``,
``train_latest.py::train_and_evaluate``, ``losses.py``, ``pqmf.py``. The
discriminator and the GAN losses are VITS's (``reference/models/mpd.py``,
``reference/training/losses.py``); the sub-band loss is ParallelWaveGAN's
(``reference/training/stft_loss.py``). The serving model
(``reference/models/mb_istft.py``) and the frozen modules it imports are
reused by import.

The generator's training forward (``TrainSynthesizer.forward``), in the
published order: the text encoder; the posterior encoder over the linear
spectrogram (all ``inter_channels``); the flow; the negative cross-entropy of
z_p under the text prior and its monotonic alignment (``reference/ops/mas.py``,
no gradient); the stochastic duration predictor's loss over the alignment's
durations, divided by the text mask's sum; the prior expanded over the
frames; one random slice a row of ``segment_size // hop`` frames of z, its
start ``int(u * (length - frames + 1))``; the multi-band iSTFT decoder, which
also returns the sub-band signals before its PQMF synthesis.

The step (``train_step``), as ``train_latest.py``: the real mel sliced at the
offsets; the real waveform sliced at offsets x hop; D on (real, detached
generated), the LSGAN D loss, an AdamW update of D (``reference/step.py::
AdamW``: torch's formula written out, weight decay 1e-2, constant learning
rate); the updated D on (real, generated) with D's parameters out of
autograd, and G's loss adversarial + feature matching + mel L1 x ``c_mel`` +
duration + KL x ``c_kl`` + the sub-band STFT loss between the PQMF analysis of
the real segment (a 63-tap convolution of the padded signal, every
``subbands``-th output kept) and the generated sub-bands; an AdamW update of G.

``train_step_blocks`` computes the same step ``block`` rows at a time, so
that a float32 step at the published batch fits the card beside the
program's freed state: every mean over equal shapes is a mean of the
blocks' means weighted by their rows; the KL and duration losses divide by
the totals over the batch; the spectral convergence, a ratio of two norms
over the whole batch, takes its squared norms summed over the blocks in the
D pass (the generator's forward there has the same weights and draws) and
each block's gradient from ``N_b / (2 sqrt(N) sqrt(D))``, whose gradient is
the block's share of the ratio's.

Departures from the published code: the text ids are the port's 71-symbol
inventory; ``use_sdp`` true and the PQMF cutoff 0.15 are assumed (see
``reference/models/mb_istft.py``); one speaker, so no speaker embedding; the
random draws (the posterior sample, the SDP's noise, the slice offsets) are
handed in; no gradient scaler (``fp16_run`` is false) and a constant
learning rate (the steps compared stay inside the first epoch); PyTorch's
``AdamW`` is written out.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from perfbench.reference.models import mb_istft
from perfbench.reference.models.mb_istft import istft
from perfbench.reference.models.modules import LRELU_SLOPE
from perfbench.reference.ops.commons import sequence_mask, slice_segments
from perfbench.reference.ops.mas import maximum_path
from perfbench.reference.ops.pqmf import _pqmf_filters
from perfbench.reference.ops.stft import mel_spectrogram, spec_to_mel
from perfbench.reference.text.symbols import symbols
from perfbench.reference.training import losses as L
from perfbench.reference.training.stft_loss import MultiResolutionSTFTLoss, flat

BATCH_KEYS = ("x", "x_lengths", "spec", "spec_lengths", "wav")
NOISE_KEYS = ("eps_spec", "e_q", "slice_u")


def decode_with_bands(dec: mb_istft.MultiBandISTFTDecoder, x):
    """``Multiband_iSTFT_Generator.forward``: z [B, C, T] -> (waveform [B, 1,
    T'], sub-bands [B, N, T' / N])."""
    x = dec.conv_pre(x)
    for i, up in enumerate(dec.ups):
        x = up(F.leaky_relu(x, LRELU_SLOPE))
        xs = None
        for j in range(dec.num_kernels):
            r = dec.resblocks[i * dec.num_kernels + j](x)
            xs = r if xs is None else xs + r
        x = xs / dec.num_kernels
    x = F.leaky_relu(x)
    x = F.pad(x, (1, 0), mode="reflect")
    x = dec.subband_conv_post(x)
    b, _, t = x.shape
    x = x.reshape(b, dec.subbands, dec.n_fft + 2, t)
    half = dec.n_fft // 2 + 1
    if x.device.type == "meta":  # a FLOP count: the inverse DFT, like an FFT, is not counted
        y_mb_hat = x.new_empty((b, dec.subbands, dec.hop * (t - 1)))
    else:
        y_mb_hat = istft(torch.exp(x[:, :, :half]), math.pi * torch.sin(x[:, :, half:]),
                         dec.n_fft, dec.hop)
    y_g_hat = dec.pqmf.synthesis(y_mb_hat.transpose(1, 2)).transpose(1, 2)
    return y_g_hat, y_mb_hat


def pqmf_analysis(y, subbands: int = 4, taps: int = 62, cutoff: float = mb_istft.PQMF_CUTOFF,
                  beta: float = 9.0):
    """PQMF analysis: y [B, 1, T] -> [B, N, T / N] (the published ``PQMF.
    analysis``: the analysis filters over the signal padded by taps / 2 on
    both sides, then every N-th output)."""
    h_a, _ = _pqmf_filters(subbands, taps, cutoff, beta)
    w = torch.from_numpy(h_a).to(y.device, y.dtype)[:, None, :]  # [N, 1, taps + 1]
    out = F.conv1d(F.pad(y, (taps // 2, taps // 2)), w)
    updown = torch.zeros((subbands, subbands, subbands), device=y.device, dtype=y.dtype)
    for k in range(subbands):
        updown[k, k, 0] = 1.0
    return F.conv1d(out, updown, stride=subbands)


class TrainSynthesizer(mb_istft.MBISTFTSynthesizer):
    """The serving model with MB-iSTFT-VITS's training forward."""

    def forward(self, x, x_lengths, y, y_lengths, *, noise, x_mask_total=None):
        """x [B, T_x]; y [B, T_y, spec] linear spectrogram -> the published
        tuple as a dict (channels-last where the port's is): ``wav`` [B, seg,
        1], ``wav_bands`` [B, seg / N, N], ``l_length`` [B], ``attn``,
        ``ids_slice``, ``z_mask``, ``z_p``, ``m_p``, ``logs_p``, ``logs_q``."""
        x, m_p, logs_p, x_mask = self.text_encoder(x, None, x_lengths)
        g = None
        z, m_q, logs_q, y_mask = self.posterior_encoder(
            y.transpose(1, 2), y_lengths, g=g, eps=noise["eps_spec"].transpose(1, 2))
        z_p = self.flow(z, y_mask, g=g)

        with torch.no_grad():
            # negative cross-entropy
            s_p_sq_r = torch.exp(-2 * logs_p)  # [b, d, t]
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, [1], keepdim=True)
            neg_cent2 = torch.matmul(-0.5 * (z_p**2).transpose(1, 2), s_p_sq_r)
            neg_cent3 = torch.matmul(z_p.transpose(1, 2), (m_p * s_p_sq_r))
            neg_cent4 = torch.sum(-0.5 * (m_p**2) * s_p_sq_r, [1], keepdim=True)
            neg_cent = neg_cent1 + neg_cent2 + neg_cent3 + neg_cent4
            attn_mask = torch.unsqueeze(x_mask, 2) * torch.unsqueeze(y_mask, -1)
            attn = maximum_path(neg_cent, attn_mask.squeeze(1)).unsqueeze(1).detach()

        w = attn.sum(2)
        l_length = self.duration_predictor(x, x_mask, w, g=g, e_q=noise["e_q"].transpose(1, 2))
        l_length = l_length / (torch.sum(x_mask) if x_mask_total is None else x_mask_total)

        # expand prior
        m_p = torch.matmul(attn.squeeze(1), m_p.transpose(1, 2)).transpose(1, 2)
        logs_p = torch.matmul(attn.squeeze(1), logs_p.transpose(1, 2)).transpose(1, 2)

        frames = self.segment_frames
        ids_str_max = (y_lengths - frames + 1).float()
        ids_slice = torch.clamp((noise["slice_u"].float() * ids_str_max).to(torch.int32), min=0)
        z_slice = slice_segments(z.transpose(1, 2), ids_slice, frames).transpose(1, 2)
        o, o_mb = decode_with_bands(self.waveform_decoder, z_slice)

        def cl(v):
            return v.transpose(1, 2)

        return {"wav": cl(o), "wav_bands": cl(o_mb), "l_length": l_length,
                "attn": attn.squeeze(1), "ids_slice": ids_slice, "z_mask": cl(y_mask),
                "z_p": cl(z_p), "m_p": cl(m_p), "logs_p": cl(logs_p), "logs_q": cl(logs_q)}


def build(hps, device=None) -> TrainSynthesizer:
    """The training generator of a configuration on ``device``, in train mode."""
    with torch.device(device or "cpu"):
        model = TrainSynthesizer(hps, len(symbols))
    model.segment_frames = int(hps.train.segment_size) // int(hps.data.hop_length)
    return model.to(device or "cpu").train()


def _frozen(module, flag: bool):
    for p in module.parameters():
        p.requires_grad_(not flag)


def _real(batch, out, hps):
    """The real mel and waveform at the generator's offsets: (y_mel [B,
    seg_frames, mels], y [B, 1, seg])."""
    d = hps.data
    hop, seg = d.hop_length, hps.train.segment_size
    ids = out["ids_slice"].long()
    mel = spec_to_mel(batch["spec"], d.filter_length, d.n_mel_channels, d.sampling_rate,
                      d.mel_fmin, d.mel_fmax)
    y_mel = slice_segments(mel, ids, seg // hop)
    y = slice_segments(batch["wav"], ids * hop, seg).transpose(1, 2)
    return y_mel, y


def _y_hat_mel(out, hps):
    d = hps.data
    return mel_spectrogram(out["wav"][:, :, 0], d.filter_length, d.n_mel_channels,
                           d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)


def _loss_fn(hps):
    t = hps.train
    return MultiResolutionSTFTLoss(t.fft_sizes, t.hop_sizes, t.win_lengths)


def train_step(model, disc, opt_g, opt_d, batch: dict, hps, noise: dict) -> dict:
    """One D+G update on the whole batch; returns the G loss's terms
    (``score``, ``fm``, ``mel``, ``dur``, ``kl``, ``subband``), its total ``g``
    and the D loss ``d``, detached. Optimizers of None leave
    the parameters as they are (a FLOP count)."""
    c = hps.train
    model.train()
    disc.train()
    out = model(batch["x"], batch["x_lengths"], batch["spec"], batch["spec_lengths"],
                noise=noise)
    y_mel, y = _real(batch, out, hps)
    y_hat = out["wav"].transpose(1, 2)
    y_hat_mb = out["wav_bands"].transpose(1, 2)
    y_hat_mel = _y_hat_mel(out, hps)

    y_d_hat_r, y_d_hat_g, _, _ = disc(y, y_hat.detach())
    loss_disc, _, _ = L.discriminator_loss(y_d_hat_r, y_d_hat_g)
    if opt_d is not None:
        opt_d.zero_grad()
    loss_disc.backward()
    if opt_d is not None:
        opt_d.step()

    _frozen(disc, True)
    try:
        y_d_hat_r, y_d_hat_g, fmap_r, fmap_g = disc(y, y_hat)
        loss_dur = torch.sum(out["l_length"].float())
        loss_mel = F.l1_loss(y_mel, y_hat_mel) * c.c_mel
        loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                            out["z_mask"]) * c.c_kl
        loss_fm = L.feature_loss(fmap_r, fmap_g)
        loss_gen, _ = L.generator_loss(y_d_hat_g)
        y_mb = pqmf_analysis(y)
        sc, mag = _loss_fn(hps)(*flat(y_mb, y_hat_mb))
        loss_subband = sc + mag
        loss_gen_all = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl + loss_subband
        if opt_g is not None:
            opt_g.zero_grad()
        loss_gen_all.backward()
    finally:
        _frozen(disc, False)
    if opt_g is not None:
        opt_g.step()
    terms = {"score": loss_gen, "fm": loss_fm, "mel": loss_mel, "dur": loss_dur, "kl": loss_kl,
             "subband": loss_subband, "g": loss_gen_all, "d": loss_disc}
    return {k: v.detach() for k, v in terms.items()}


def train_step_blocks(model, disc, opt_g, opt_d, batch: dict, hps, noise: dict, block: int,
                      before_forward) -> dict:
    """``train_step`` computed ``block`` rows at a time (see the module
    docstring); ``before_forward(i, j, full)`` is called before each block's
    forward (to reseed and place the dropout masks, drawn for the whole
    batch). The generator forward runs once for the D update and again for
    the G update. Returns the step's losses as floats."""
    n = batch["x"].shape[0]
    c = hps.train
    x_total = sequence_mask(batch["x_lengths"], batch["x"].shape[1]).sum().float()
    z_total = batch["spec_lengths"].sum().float()
    spans = [(i, min(i + block, n)) for i in range(0, n, block)]
    loss_fn = _loss_fn(hps)
    model.train()
    disc.train()

    def forward(i, j):
        b = {k: batch[k][i:j] for k in BATCH_KEYS}
        before_forward(i, j, n)
        out = model(b["x"], b["x_lengths"], b["spec"], b["spec_lengths"],
                    noise={k: noise[k][i:j] for k in NOISE_KEYS}, x_mask_total=x_total)
        return b, out

    loss_d = 0.0
    parts = None
    opt_d.zero_grad()
    for i, j in spans:
        with torch.no_grad():
            b, out = forward(i, j)
            y_mel, y = _real(b, out, hps)
            sums = loss_fn.sc_parts(*flat(pqmf_analysis(y), out["wav_bands"].transpose(1, 2)))
            parts = sums if parts is None else [(a + u, e + v) for (a, e), (u, v)
                                                in zip(parts, sums)]
        y_d_r, y_d_g, _, _ = disc(y, out["wav"].transpose(1, 2).detach())
        part = L.discriminator_loss(y_d_r, y_d_g)[0] * ((j - i) / n)
        part.backward()
        loss_d += float(part.detach())
        del out, y_d_r, y_d_g
    opt_d.step()

    k = len(parts)
    sc = sum(torch.sqrt(num) / torch.sqrt(den) for num, den in parts) / k
    loss_g, mag_total = float(sc), 0.0
    opt_g.zero_grad()
    _frozen(disc, True)
    try:
        for i, j in spans:
            b, out = forward(i, j)
            share = (j - i) / n
            y_mel, y = _real(b, out, hps)
            y_hat = out["wav"].transpose(1, 2)
            _, y_d_g, fmap_r, fmap_g = disc(y, y_hat)
            x_mb, y_mb = flat(pqmf_analysis(y), out["wav_bands"].transpose(1, 2))
            mag = loss_fn.mag_loss(x_mb, y_mb)
            means = (L.generator_loss(y_d_g)[0] + L.feature_loss(fmap_r, fmap_g)
                     + F.l1_loss(y_mel, _y_hat_mel(out, hps)) * c.c_mel + mag)
            totals = torch.sum(out["l_length"].float()) + L.kl_loss(
                out["z_p"], out["logs_q"], out["m_p"], out["logs_p"], out["z_mask"], z_total
            ) * c.c_kl
            sc_grad = sum(num_b / (2 * torch.sqrt(num) * torch.sqrt(den))
                          for (num_b, _), (num, den) in zip(loss_fn.sc_parts(x_mb, y_mb), parts))
            (means * share + totals + sc_grad / k).backward()
            loss_g += float((means * share + totals).detach())
            mag_total += float(mag.detach()) * share
            del out, fmap_r, fmap_g, y_d_g
    finally:
        _frozen(disc, False)
    opt_g.step()
    return {"g": loss_g, "d": loss_d, "subband": float(sc) + mag_total}
