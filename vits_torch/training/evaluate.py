"""Validation loop: val losses over the FULL eval set + the reference's
complete TensorBoard payload (port of ``vits_tpu/training/evaluate.py``).

Behavioral reference: reference evaluate.py: train-style forward for val
mel/yin L1 over every batch (:26-80); first-batch synthesis via the
pre_decoder path with n_sample samples (:84-118); scope-shift(+6) re-crop of
the same latent (:104-115); yin-decoder reconstruction of the inferred z_yin
(:117-118); yingram of generated and shifted audio (:144-167); mel images on
a shared log-floor(-11.5129) time grid (:169-213); ground-truth mel/ying/audio
logged once at step 0 (:269-287).

Everything runs under ``torch.no_grad()`` with the model in ``eval()``
(dropout off, as the JAX evaluate's default ``deterministic=True``); the
model's mode is restored afterwards. The draws: the JAX code uses
``PRNGKey(0)`` for every validation batch, ``PRNGKey(1)`` for the sample
synthesis and ``PRNGKey(2)`` for the yin decoder; here ``torch.Generator``s
on the model's device seeded 0 (anew for each batch), 1 and 2, or the arrays
given in ``noise`` (``{"val": forward noise, "samples": {"sdp_noise", "eps"},
"yin_dec": {"scope_shift"}}``, any subset). The JAX module's ``_JIT_CACHE``
of compiled programs has no counterpart: eager PyTorch compiles nothing.
Without matplotlib the images are left out (the train loop names that once
in its log); the audio and scalars are still summarized. A pitchless model
(MB-iSTFT-VITS) has the mel terms alone: ``val/yin_dec`` is NaN and the
samples have no scope shift, yin decoder or Yingram images.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from vits_torch.models.synthesizer import SynthesizerTrn
from vits_torch.ops.commons import slice_segments
from vits_torch.ops.stft import mel_spectrogram, spec_to_mel
from vits_torch.ops.yin import Yingram
from vits_torch.utils.logging_utils import have_matplotlib, plot_spectrogram_to_numpy, summarize

_LOG_FLOOR = -11.5129  # log(1e-5), the reference's mel padding value
SAMPLE_MAX_FRAMES = 1024

VAL_KEYS = ("x", "t", "x_lengths", "spec", "spec_lengths", "ying", "sid")


def _generator(model: SynthesizerTrn, seed: int) -> torch.Generator:
    return torch.Generator(model.device).manual_seed(seed)


def _val_losses(model: SynthesizerTrn, batch: dict, hps, noise: dict | None = None):
    """Train-style forward -> (mel L1, yin L1) 0-d tensors (reference
    evaluate.py:44-80). Plain-weighted L1 (the c_mel/c_yin scaling divides
    back out when comparing runs; scalars stay unit-comparable across
    configs)."""
    d = hps.data
    hop = d.hop_length
    seg_frames = hps.train.segment_size // hop
    dev = model.device
    x, t, xl, spec, sl, ying, sid = (torch.as_tensor(batch[k], device=dev) for k in VAL_KEYS)
    b = x.shape[0]
    out = model(x, t, xl, spec, sl, ying, sid, noise=noise,
                generator=None if noise else _generator(model, 0))
    wav = out["wav_hier"][-1][:b] if model.has_pitch else out["wav"]
    mel = spec_to_mel(spec, d.filter_length, d.n_mel_channels, d.sampling_rate, d.mel_fmin,
                      d.mel_fmax)
    ids = out["ids_slice"].long()
    y_mel = slice_segments(mel, ids[:b], seg_frames)
    y_hat_mel = mel_spectrogram(
        wav[:, :, 0], d.filter_length, d.n_mel_channels, d.sampling_rate, hop,
        d.win_length, d.mel_fmin, d.mel_fmax,
    )
    loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel))
    if not model.has_pitch:
        return loss_mel, None
    loss_yin = torch.mean(torch.abs(out["yin_gt_shifted_crop"] - out["yin_dec_crop"]))
    return loss_mel, loss_yin


def _pad_to(arr: np.ndarray, n: int, fill: float) -> np.ndarray:
    """Pad/trim leading (time) axis of [T, C] to n with a fill value."""
    if arr.shape[0] >= n:
        return arr[:n]
    pad = np.full((n - arr.shape[0], arr.shape[1]), fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _sample_outputs(model: SynthesizerTrn, batch: dict, n_sample: int, hps,
                    noise: dict | None = None) -> dict:
    """The first batch's synthesis payload on the model's device, as numpy."""
    d = hps.data
    hop = d.hop_length
    dev = model.device
    noise = noise or {}
    x, t, xl, sid, spec = (torch.as_tensor(batch[k][:n_sample], device=dev)
                           for k in ("x", "t", "x_lengths", "sid", "spec"))
    samples = noise.get("samples")
    dec_inputs, y_mask, y_lengths, aux = model.infer_pre_decoder(
        x, t, xl, sid, noise=samples, generator=None if samples else _generator(model, 1),
        noise_scale=0.667, noise_scale_w=0.8, max_frames=SAMPLE_MAX_FRAMES,
    )
    _, z, *_ = aux
    y_hat = model.infer_decode_chunk(dec_inputs, sid)  # [B, T*hop, 1]
    mel_kw = (d.filter_length, d.n_mel_channels, d.sampling_rate, hop, d.win_length,
              d.mel_fmin, d.mel_fmax)
    out = dict(
        y_lengths=y_lengths,
        y_hat=y_hat,
        mel_gt=spec_to_mel(spec, d.filter_length, d.n_mel_channels, d.sampling_rate,
                           d.mel_fmin, d.mel_fmax),
        mel_gen=mel_spectrogram(y_hat[..., 0], *mel_kw),
    )
    if model.has_pitch:
        out.update(_pitch_outputs(model, z, y_mask, y_hat, sid, noise, hps))
        out["mel_gen_shift"] = mel_spectrogram(out["y_hat_shift"][..., 0], *mel_kw)
    return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in out.items()}


def _pitch_outputs(model: SynthesizerTrn, z, y_mask, y_hat, sid, noise: dict, hps) -> dict:
    """The samples' pitch payload: the scope-shifted audio, the yin decoder's
    reconstruction and the Yingrams."""
    d = hps.data
    hop = d.hop_length
    # scope-shift(+6): re-crop the SAME latent z (reference :104-115)
    spec_ch = model.inter_channels - model.yin_channels
    z_spec, z_yin = z[..., :spec_ch], z[..., spec_ch:]
    s = model.yin_start + 6
    z_crop_shift = torch.cat([z_spec, z_yin[..., s : s + model.yin_scope]], dim=-1) * y_mask
    y_hat_shift = model.infer_decode_chunk(z_crop_shift, sid)

    # yin-decoder reconstruction of the pitch latent (:117-118)
    yin_noise = noise.get("yin_dec")
    yin_hat = model.yin_dec_infer(
        z_yin * y_mask, y_mask, sid, noise=yin_noise,
        generator=None if yin_noise else _generator(model, 2),
    )

    # yingram of generated + shifted audio, reference pad (:144-167)
    ying_op = Yingram(d.sampling_rate, hop, 2048, d.tau_max, d.midi_start, d.midi_end,
                      d.octave_range)

    def _ying_of(o):
        o = o[..., 0]
        left = d.filter_length - hop
        right = left + (-o.shape[-1]) % hop + hop * (o.shape[-1] % hop == 0)
        return ying_op(F.pad(o, (left, right)))

    return dict(
        y_hat_shift=y_hat_shift,
        yin_hat=yin_hat,
        z_yin_masked=z_yin * y_mask,
        ying_hat=_ying_of(y_hat),
        ying_hat_shift=_ying_of(y_hat_shift),
    )


def _log_samples(model, batch, writer, global_step, hps, noise=None) -> dict:
    """First-batch TB payload (reference evaluate.py:84-287). Returns the
    audio it logged (name -> waveform)."""
    hop = hps.data.hop_length
    n_sample = min(int(hps.train.get("n_sample", 1)), batch["x"].shape[0])
    out = _sample_outputs(model, batch, n_sample, hps, noise)
    plot = plot_spectrogram_to_numpy if have_matplotlib() else None
    spec_lengths = np.asarray(batch["spec_lengths"])

    images, audios = {}, {}
    for i in range(n_sample):
        n_frames = int(out["y_lengths"][i])
        gt_frames = int(spec_lengths[i])
        grid = max(n_frames, gt_frames)  # shared log-floor time grid (:169+)
        if plot is not None:
            for name, key, fill in (("mel", "mel_gen", _LOG_FLOOR),
                                    ("mel_shift", "mel_gen_shift", _LOG_FLOOR),
                                    ("z_yin", "z_yin_masked", 0.0), ("yin_dec", "yin_hat", 0.0),
                                    ("ying", "ying_hat", 0.0), ("ying_shift", "ying_hat_shift", 0.0)):
                if key in out:
                    images[f"gen/{i}_{name}"] = plot(_pad_to(out[key][i, :n_frames], grid, fill))
        audios[f"gen/{i}_audio"] = out["y_hat"][i, : n_frames * hop, 0]
        if "y_hat_shift" in out:
            audios[f"gen/{i}_audio_shift"] = out["y_hat_shift"][i, : n_frames * hop, 0]
        if global_step == 0:  # ground truth once (reference :269-287)
            if plot is not None:
                images[f"gt/{i}_mel"] = plot(out["mel_gt"][i, :gt_frames])
                if model.has_pitch:
                    images[f"gt/{i}_ying"] = plot(np.asarray(batch["ying"][i, :gt_frames]))
            audios[f"gt/{i}_audio"] = np.asarray(batch["wav"][i, : gt_frames * hop, 0])
    summarize(
        writer, global_step, images=images, audios=audios,
        audio_sampling_rate=hps.data.sampling_rate,
    )
    return audios


def evaluate(
    model: SynthesizerTrn,
    val_iter,
    writer,
    global_step: int,
    hps,
    max_batches: int | None = None,
    noise: dict | None = None,
) -> dict:
    """Full-val-set losses + first-batch sample payload. Returns scalars."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            mel_losses, yin_losses = [], []
            first_batch = None
            for bi, batch in enumerate(val_iter):
                if max_batches is not None and bi >= max_batches:
                    break
                loss_mel, loss_yin = _val_losses(model, batch, hps, (noise or {}).get("val"))
                mel_losses.append(float(loss_mel))
                if loss_yin is not None:
                    yin_losses.append(float(loss_yin))
                if first_batch is None:
                    first_batch = batch

            if first_batch is not None and writer is not None:
                _log_samples(model, first_batch, writer, global_step, hps, noise)
    finally:
        model.train(was_training)

    scalars = {
        "val/mel": float(np.mean(mel_losses)) if mel_losses else float("nan"),
        "val/yin_dec": float(np.mean(yin_losses)) if yin_losses else float("nan"),
    }
    if writer is not None:
        summarize(writer, global_step, scalars=scalars)
    return scalars
