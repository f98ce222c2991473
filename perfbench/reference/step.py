"""One GAN training step in plain PyTorch, one process: the discriminator
update, then the generator update against the updated discriminator.

The same mathematics as the program's ``train_step`` at the time the
benchmark was written: the generator forward in train mode; the real mel and
the doubled real waveform sliced at the generator's offsets; PhaseAug
(``phi_d``) on (real, detached generated last scale), the LSGAN D loss and
an AdamW update of D; PhaseAug (``phi_g``) on (real, live generated), the
updated D frozen, adversarial + feature matching + mel L1 x ``c_mel`` +
duration + KL x ``c_kl`` + the two yin losses x ``c_yin``, and an AdamW update
of G. AdamW is written out (``AdamW``): torch's formula, weight decay 1e-2,
betas and eps from the configuration, a constant learning rate (the step
counts compared stay inside the first epoch of the schedule). Every
parameter takes part in every update, a zero gradient where it has none.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.ops.commons import slice_segments
from perfbench.reference.ops.phaseaug import phaseaug_sync
from perfbench.reference.ops.stft import mel_spectrogram, spec_to_mel
from perfbench.reference.training import losses as L

BATCH_KEYS = ("x", "t", "x_lengths", "spec", "spec_lengths", "ying", "wav", "sid")


class AdamW:
    """AdamW over a list of named parameters, torch's update written out:
    p *= 1 - lr * wd; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr / (1 - b1^k) * m / (sqrt(v) / sqrt(1 - b2^k) + eps)."""

    def __init__(self, named_params, lr, betas, eps, weight_decay=1e-2):
        self.params = list(named_params)
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.k = 0
        self.first_grads: dict[str, torch.Tensor] | None = None

    @torch.no_grad()
    def step(self):
        self.k += 1
        bc1, bc2 = 1 - self.b1**self.k, 1 - self.b2**self.k
        grads = {}
        for n, p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = g
            p.mul_(1 - self.lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / bc1)
        if self.first_grads is None:
            self.first_grads = {n: g.norm().item() for n, g in grads.items()}

    def zero_grad(self):
        for _, p in self.params:
            p.grad = None


def make_adamw(hps, module):
    t = hps.train
    return AdamW(list(module.named_parameters()), float(t.learning_rate),
                 (float(t.betas[0]), float(t.betas[1])), float(t.eps))


def _frozen(module, flag: bool):
    for p in module.parameters():
        p.requires_grad_(not flag)


def train_step(model, disc, opt_g: AdamW, opt_d: AdamW, batch: dict, hps, noise: dict) -> dict:
    """One D+G update; returns {"g": total G loss, "d": D loss}, detached.
    Optimizers of None leave the parameters as they are (a FLOP count)."""
    b = {k: batch[k] for k in BATCH_KEYS}
    d = hps.data
    hop, seg = d.hop_length, hps.train.segment_size
    seg_frames = seg // hop
    bsz = b["x"].shape[0]
    model.train()
    disc.train()
    out = model(b["x"], b["t"], b["x_lengths"], b["spec"], b["spec_lengths"], b["ying"],
                b["sid"], noise=noise)
    ids = out["ids_slice"].long()

    mel = spec_to_mel(b["spec"], d.filter_length, d.n_mel_channels, d.sampling_rate,
                      d.mel_fmin, d.mel_fmax)
    y_mel = slice_segments(mel, ids[:bsz], seg_frames)
    wav2 = torch.cat([b["wav"], b["wav"]], dim=0)
    y_sliced = slice_segments(wav2, ids * hop, seg)

    fake = [w.detach() for w in out["wav_hier"]]
    aug_y, aug_fake = phaseaug_sync(y_sliced, fake[-1], phi=noise["phi_d"])
    y_d_r, y_d_g, _, _ = disc(aug_y, [fake[0], fake[1], aug_fake])
    loss_disc, _, _ = L.discriminator_loss(y_d_r, y_d_g)
    if opt_d is not None:
        opt_d.zero_grad()
    loss_disc.backward()
    if opt_d is not None:
        opt_d.step()

    c = hps.train
    wav_hier = out["wav_hier"]
    _frozen(disc, True)
    try:
        aug_y, aug_hat = phaseaug_sync(y_sliced, wav_hier[-1], phi=noise["phi_g"])
        y_d_r, y_d_g, fmap_r, fmap_g = disc(aug_y, [wav_hier[0], wav_hier[1], aug_hat])
        y_hat_mel = mel_spectrogram(wav_hier[-1][:bsz, :, 0], d.filter_length, d.n_mel_channels,
                                    d.sampling_rate, hop, d.win_length, d.mel_fmin, d.mel_fmax)
        yin_gt_crop_sliced = slice_segments(
            torch.cat([out["yin_gt_crop"], out["yin_gt_shifted_crop"]], dim=0), ids, seg_frames)
        loss_dur = torch.sum(out["l_length"].float())
        loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * c.c_mel
        loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                            out["z_mask"]) * c.c_kl
        loss_yin_dec = torch.mean(
            torch.abs(out["yin_gt_shifted_crop"] - out["yin_dec_crop"])) * c.c_yin
        loss_yin_shift = (
            torch.mean(torch.abs(torch.exp(-yin_gt_crop_sliced) - torch.exp(-out["yin_hat_crop"])))
            * c.c_yin
            + torch.mean(torch.abs(torch.exp(-out["yin_hat_shifted"])
                                   - torch.exp(-out["yin_hat_crop"][bsz:]))) * c.c_yin
        )
        loss_fm = L.feature_loss(fmap_r, fmap_g)
        loss_gen, _ = L.generator_loss(y_d_g)
        loss_total = (loss_gen + loss_fm + loss_mel + loss_dur + loss_kl + loss_yin_shift
                      + loss_yin_dec)
        if opt_g is not None:
            opt_g.zero_grad()
        loss_total.backward()
    finally:
        _frozen(disc, False)
    if opt_g is not None:
        opt_g.step()
    return {"g": loss_total.detach(), "d": loss_disc.detach()}


def _rows(batch: dict, noise: dict, i: int, j: int, full: int) -> tuple[dict, dict]:
    """Rows i:j of a batch and of its draws (PhaseAug's rotations are over
    the doubled batch: rows i:j and full+i:full+j)."""
    b = {k: batch[k][i:j] for k in BATCH_KEYS}
    n = {k: v[i:j] for k, v in noise.items() if k not in ("phi_d", "phi_g")}
    for k in ("phi_d", "phi_g"):
        n[k] = torch.cat([noise[k][i:j], noise[k][full + i: full + j]], dim=0)
    return b, n


def train_step_blocks(model, disc, opt_g: AdamW, opt_d: AdamW, batch: dict, hps, noise: dict,
                      block: int, before_forward, rows: int | None = None) -> dict:
    """``train_step`` over the first ``rows`` rows of the batch (all unless
    given), computed ``block`` rows at a time so that a float32 step fits the
    card: every mean is a mean over the ``rows`` rows, the KL and duration
    losses divide by the totals over them, and the gradients of the blocks
    add up to the whole batch's. The generator forward runs once for the D
    update and again for the G update (the same draws; ``before_forward(i,
    j, full)`` is called before each block's forward, to reseed and place
    the dropout masks, which are drawn for the whole batch). Returns the
    losses of the whole step as floats."""
    full = batch["x"].shape[0]
    n = full if rows is None else rows
    d = hps.data
    hop, seg = d.hop_length, hps.train.segment_size
    seg_frames = seg // hop
    c = hps.train
    x_total = batch["x_lengths"][:n].sum().float()
    z_total = batch["spec_lengths"][:n].sum().float()
    spans = [(i, min(i + block, n)) for i in range(0, n, block)]
    model.train()
    disc.train()

    def forward(i, j):
        b, nz = _rows(batch, noise, i, j, full)
        before_forward(i, j, full)
        out = model(b["x"], b["t"], b["x_lengths"], b["spec"], b["spec_lengths"], b["ying"],
                    b["sid"], noise=nz, x_mask_total=x_total)
        ids = out["ids_slice"].long()
        wav2 = torch.cat([b["wav"], b["wav"]], dim=0)
        return b, nz, out, ids, slice_segments(wav2, ids * hop, seg)

    loss_d = 0.0
    opt_d.zero_grad()
    for i, j in spans:
        with torch.no_grad():
            _, nz, out, _, y_sliced = forward(i, j)
        fake = [w.detach() for w in out["wav_hier"]]
        aug_y, aug_fake = phaseaug_sync(y_sliced, fake[-1], phi=nz["phi_d"])
        y_d_r, y_d_g, _, _ = disc(aug_y, [fake[0], fake[1], aug_fake])
        part = L.discriminator_loss(y_d_r, y_d_g)[0] * ((j - i) / n)
        part.backward()
        loss_d += float(part.detach())
        del out, fake, y_d_r, y_d_g
    opt_d.step()

    loss_g = 0.0
    opt_g.zero_grad()
    _frozen(disc, True)
    try:
        for i, j in spans:
            b, nz, out, ids, y_sliced = forward(i, j)
            bsz = j - i
            mel = spec_to_mel(b["spec"], d.filter_length, d.n_mel_channels, d.sampling_rate,
                              d.mel_fmin, d.mel_fmax)
            y_mel = slice_segments(mel, ids[:bsz], seg_frames)
            wav_hier = out["wav_hier"]
            aug_y, aug_hat = phaseaug_sync(y_sliced, wav_hier[-1], phi=nz["phi_g"])
            _, y_d_g, fmap_r, fmap_g = disc(aug_y, [wav_hier[0], wav_hier[1], aug_hat])
            y_hat_mel = mel_spectrogram(wav_hier[-1][:bsz, :, 0], d.filter_length,
                                        d.n_mel_channels, d.sampling_rate, hop, d.win_length,
                                        d.mel_fmin, d.mel_fmax)
            yin_gt = slice_segments(
                torch.cat([out["yin_gt_crop"], out["yin_gt_shifted_crop"]], dim=0), ids,
                seg_frames)
            means = (
                L.generator_loss(y_d_g)[0] + L.feature_loss(fmap_r, fmap_g)
                + torch.mean(torch.abs(y_mel - y_hat_mel)) * c.c_mel
                + torch.mean(torch.abs(out["yin_gt_shifted_crop"] - out["yin_dec_crop"])) * c.c_yin
                + torch.mean(torch.abs(torch.exp(-yin_gt) - torch.exp(-out["yin_hat_crop"])))
                * c.c_yin
                + torch.mean(torch.abs(torch.exp(-out["yin_hat_shifted"])
                                       - torch.exp(-out["yin_hat_crop"][bsz:]))) * c.c_yin
            )
            totals = torch.sum(out["l_length"].float()) + L.kl_loss(
                out["z_p"], out["logs_q"], out["m_p"], out["logs_p"], out["z_mask"], z_total
            ) * c.c_kl
            part = means * (bsz / n) + totals
            part.backward()
            loss_g += float(part.detach())
            del out, wav_hier, fmap_r, fmap_g, y_d_g
    finally:
        _frozen(disc, False)
    opt_g.step()
    return {"g": loss_g, "d": loss_d}
