"""The GAN training step: one discriminator update, then one generator
update against the updated discriminator (port of
``vits_tpu/training/step.py``).

In the JAX package's order:
  1. one generator forward in train mode; its autograd graph is kept for the
     generator's backward (where JAX linearises once with ``jax.vjp``);
  2. the real mel, sliced at the generator's offsets, and the real waveform
     doubled and sliced at ``ids * hop``;
  3. D step: PhaseAug (``phi_d``) on (real, detached generated last scale),
     the LSGAN D loss, ``optim_d.step()``;
  4. G step: PhaseAug (``phi_g``) on (real, live generated last scale), the
     updated D, adversarial + feature matching + mel L1 x ``c_mel`` +
     duration + KL x ``c_kl`` + yin losses x ``c_yin``; the backward runs
     through the kept generator graph with D's parameters frozen, so no D
     gradient is computed in this pass; ``optim_g.step()``.

Both optimizers are ``torch.optim.AdamW`` (betas and eps from the config,
weight decay 1e-2) with the staircase per-epoch exponential decay applied to
the learning rate before each update, from the optimizer's own update count.
Every parameter takes part in every update (a parameter without a gradient
gets a zero one, so that weight decay reaches it, as it does in optax).

Each phase is a span of ``utils/profiling.py`` (live while tracing is on):
``train.inputs`` (the batch to the device, the draws), ``train.g_forward``,
``train.d_forward`` (the real side, PhaseAug, D, its loss),
``train.d_backward``, ``train.d_update`` (the metrics' stack, the gradient
norm, the lr, ``AdamW.step``), ``train.g_loss``, ``train.g_backward``,
``train.g_update``.

``hps.train.remat_run`` wraps the generator forward and each discriminator
application in ``torch.utils.checkpoint``. ``hps.train.nan_guard`` reverts a
side's parameters and Adam moments when its loss or gradient norm is not
finite; the update counts still advance, as in the JAX package.

Randomness: ``noise`` (the generator's draws as ``SynthesizerTrn.forward``
takes them, plus ``phi_d`` and ``phi_g`` [2B, 513], one rotation per row of
the doubled batch) or one ``torch.Generator``, all drawn before the forward;
dropout draws from PyTorch's default generator. On a card the MAS inside the
generator forward is the ``mas_fused`` kernel; the step runs where the models
are (``cuda`` unless they were built with ``device='cpu'``).

Data parallel (``replicate_state``; ``state.ddp`` holds the DDP wrappers of
the generator and the discriminator, ``state.model`` and ``state.disc`` stay
the plain modules). Each rank holds ``B / world`` rows of the global batch,
padded to the same bucket bound, and the step computes what one process
computes on the global batch (the JAX step on the sharded global array):
  * the draws are made for the global batch, from the same generator on
    every rank, and each rank keeps its rows (``parallel.mesh.rank_rows``);
  * every loss that is a mean over equal shapes (mel L1, feature matching,
    LSGAN, yin) has the global mean as the mean of the ranks' means;
  * the two ratio losses, KL over ``sum(z_mask)`` and the duration loss over
    ``sum(x_mask)``, divide each rank's numerator by the mean of the ranks'
    denominators (``ratio_denominator``): each rank's loss is ``world``
    times its exact share of the global loss, so DDP's gradient average is
    the gradient of the global loss;
  * the returned losses are averaged over the ranks (the global values);
    the gradient norms are read after DDP's all-reduce, and ``nan_guard``
    decides on the averaged loss and that norm, so every rank keeps or
    reverts the same update.
The D step goes through the discriminator's wrapper; the G step applies the
plain discriminator (frozen), so its reducer waits for no gradient there.
Every generator and discriminator parameter gets a gradient in a step, so
DDP needs neither ``find_unused_parameters`` nor ``static_graph``.

Tensor parallel on a 2-D mesh (``parallel.mesh.make_mesh_2d``, then
``tp_shard_generator`` before ``create_train_state``): the "ranks" above
are the data ranks (``mesh.data_index`` / ``data_count``), DDP and the means
run over the data group, and the model peers of a data rank hold the same
rows and draws. The decoder's split convs gather their channels inside the
forward, so every model peer computes the same losses; the gradient norm
sums the split tensors' shares over the model group (``mesh.grad_norm``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from vits_torch.models.avocodo import AvocodoDiscriminator
from vits_torch.models.synthesizer import FORWARD_NOISE, SynthesizerTrn
from vits_torch.ops.commons import sequence_mask, slice_segments
from vits_torch.ops.phaseaug import phaseaug_sync, sample_phi
from vits_torch.ops.stft import mel_spectrogram, spec_to_mel
from vits_torch.parallel import mesh
from vits_torch.training import losses as L
from vits_torch.utils.profiling import span

BATCH_KEYS = ("x", "t", "x_lengths", "spec", "spec_lengths", "ying", "wav", "sid")


def lr_schedule(hps, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate after ``count`` updates: ``learning_rate * lr_decay **
    (count // steps_per_epoch)`` (ExponentialLR stepped once an epoch)."""
    init, decay = float(hps.train.learning_rate), float(hps.train.lr_decay)
    period = max(steps_per_epoch, 1)
    return lambda count: init * decay ** (count // period)


def make_optimizer(hps, params) -> torch.optim.AdamW:
    """AdamW with the config's betas and eps and torch's default weight
    decay of 1e-2; the learning rate is set from ``lr_schedule`` per step."""
    return torch.optim.AdamW(
        params,
        lr=float(hps.train.learning_rate),
        betas=(float(hps.train.betas[0]), float(hps.train.betas[1])),
        eps=float(hps.train.eps),
        weight_decay=1e-2,
    )


@dataclasses.dataclass
class TrainState:
    """What a run carries from step to step; ``train_step`` updates it in
    place."""

    step: int
    model: SynthesizerTrn
    disc: AvocodoDiscriminator
    optim_g: torch.optim.AdamW
    optim_d: torch.optim.AdamW
    schedule: Callable[[int], float]
    # (generator, discriminator) under DDP, or None in one process
    ddp: tuple | None = None


class Remat(torch.nn.Module):
    """``module``'s forward under non-reentrant ``torch.utils.checkpoint``
    (``remat_run``). Under DDP this is the module the wrapper holds, so the
    replay happens inside DDP's forward and backward."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        return checkpoint(self.module, *args, use_reentrant=False, **kwargs)


def create_train_state(
    model: SynthesizerTrn, disc: AvocodoDiscriminator, hps, steps_per_epoch: int
) -> TrainState:
    return TrainState(
        step=0,
        model=model,
        disc=disc,
        optim_g=make_optimizer(hps, model.parameters()),
        optim_d=make_optimizer(hps, disc.parameters()),
        schedule=lr_schedule(hps, steps_per_epoch),
    )


def replicate_state(state: TrainState, hps) -> TrainState:
    """Wrap the generator and the discriminator in DDP (each inside ``Remat``
    under ``remat_run``): rank 0's parameters are broadcast to every rank
    now. Call it in every process of the group, after a resume's load."""
    remat = bool(hps.train.get("remat_run", False))
    state.ddp = tuple(mesh.wrap(Remat(m) if remat else m) for m in (state.model, state.disc))
    return state


def ratio_denominator(local_total: torch.Tensor) -> torch.Tensor:
    """A ratio loss's denominator under data parallel: the mean over the
    ranks of their totals (see the module docstring)."""
    return mesh.all_mean(local_total.float())


def update_count(optim: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (AdamW's per-parameter ``step``)."""
    for p in optim.param_groups[0]["params"]:
        if "step" in optim.state[p]:
            return int(optim.state[p]["step"])
    return 0


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """Parameters out of autograd for the block (no weight gradients)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def apply_update(optim, schedule, loss, nan_guard: bool):
    """Set the scheduled lr, step; returns the gradient norm and, under
    nan_guard, 1.0 where the update was reverted."""
    params = [p for g in optim.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = mesh.grad_norm(params)  # optax.global_norm
    lr = schedule(update_count(optim))
    for group in optim.param_groups:
        group["lr"] = lr
    if not nan_guard:
        optim.step()
        return grad_norm, None
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    with torch.no_grad():
        old = [p.detach().clone() for p in params]
        moments = [{k: v.clone() for k, v in optim.state[p].items() if k != "step"}
                   for p in params]
        optim.step()
        for p, o, m in zip(params, old, moments):
            p.copy_(torch.where(ok, p, o))
            for k, v in optim.state[p].items():
                if k != "step":  # the count advances either way
                    v.copy_(torch.where(ok, v, m[k] if k in m else torch.zeros_like(v)))
    return grad_norm, 1.0 - ok.float()


def train_step(state: TrainState, batch: dict, hps, *, noise: dict | None = None,
               generator: torch.Generator | None = None) -> dict:
    """One D+G update on ``batch`` (keys ``BATCH_KEYS``; JAX layout: spec
    [B, T_y, F], ying [B, T_y, M], wav [B, T_y * hop, 1]). Updates ``state``
    in place and returns the metrics as 0-d tensors on the model's device.
    Afterwards every parameter's ``.grad`` holds the gradient its update
    used. Under DDP (``state.ddp``) ``batch`` is this rank's rows, ``noise``
    is drawn for the global batch, and the metrics are the global ones."""
    model, disc = state.model, state.disc
    dev = model.device
    d = hps.data
    hop, seg = d.hop_length, hps.train.segment_size
    seg_frames = seg // hop
    remat = bool(hps.train.get("remat_run", False))
    nan_guard = bool(hps.train.get("nan_guard", False))
    ddp = state.ddp is not None
    world = mesh.data_count() if ddp else 1

    with span("train.inputs"):
        b = {k: torch.as_tensor(batch[k], device=dev) for k in BATCH_KEYS}
        bsz, t_x = b["x"].shape
        batch_global = bsz * world
        noise = dict(noise or {})
        if any(k not in noise for k in FORWARD_NOISE):
            noise = {**model.draw_noise(batch_global, t_x, b["spec"].shape[1], generator),
                     **noise}
        for k in ("phi_d", "phi_g"):  # PhaseAug rotates the 2B rows of (real, generated)
            if k not in noise:
                noise[k] = sample_phi(2 * batch_global, generator, dev)
        if ddp:
            noise = mesh.rank_rows(noise, mesh.data_index(), world, batch_global)
        phi_d, phi_g = (torch.as_tensor(noise[k], device=dev) for k in ("phi_d", "phi_g"))

    if ddp:
        gen_apply, disc_apply = state.ddp
        x_total = ratio_denominator(sequence_mask(b["x_lengths"], t_x).sum())
    else:
        gen_apply, disc_apply = (Remat(m) if remat else m for m in (model, disc))
        x_total = None
    frozen_disc_apply = Remat(disc) if remat else disc

    # -- 1. generator forward, its graph kept for the G backward ------------
    gen_apply.train()
    disc_apply.train()
    gen_args = (b["x"], b["t"], b["x_lengths"], b["spec"], b["spec_lengths"], b["ying"],
                b["sid"])
    with span("train.g_forward"):
        out = gen_apply(*gen_args, noise=noise, x_mask_total=x_total)
    ids = out["ids_slice"].long()  # [2B], halves identical

    with span("train.d_forward"):
        # -- 2. the real side --------------------------------------------------
        mel = spec_to_mel(b["spec"], d.filter_length, d.n_mel_channels, d.sampling_rate,
                          d.mel_fmin, d.mel_fmax)
        y_mel = slice_segments(mel, ids[:bsz], seg_frames)
        wav2 = torch.cat([b["wav"], b["wav"]], dim=0)
        y_sliced = slice_segments(wav2, ids * hop, seg)  # [2B, seg, 1]

        # -- 3. discriminator step ---------------------------------------------
        fake = [w.detach() for w in out["wav_hier"]]
        aug_y, aug_fake = phaseaug_sync(y_sliced, fake[-1], phi=phi_d)
        y_d_r, y_d_g, _, _ = disc_apply(aug_y, [fake[0], fake[1], aug_fake])
        loss_disc, r_losses, g_losses = L.discriminator_loss(y_d_r, y_d_g)
    with span("train.d_backward"):
        state.optim_d.zero_grad(set_to_none=True)
        loss_disc.backward()
    with span("train.d_update"):
        d_metrics = torch.stack([loss_disc, sum(r_losses), sum(g_losses)]).detach()
        if ddp:
            d_metrics = mesh.all_mean(d_metrics)
        grad_norm_d, skipped_d = apply_update(state.optim_d, state.schedule, d_metrics[0],
                                              nan_guard)

    # -- 4. generator step against the updated D -------------------------------
    # D stays frozen through the backward: a checkpointed D replays there
    wav_hier = out["wav_hier"]
    c = hps.train
    with frozen(disc):
        with span("train.g_loss"):
            aug_y, aug_hat = phaseaug_sync(y_sliced, wav_hier[-1], phi=phi_g)
            y_d_r, y_d_g, fmap_r, fmap_g = frozen_disc_apply(
                aug_y, [wav_hier[0], wav_hier[1], aug_hat])
            y_hat_mel = mel_spectrogram(wav_hier[-1][:bsz, :, 0], d.filter_length,
                                        d.n_mel_channels, d.sampling_rate, hop, d.win_length,
                                        d.mel_fmin, d.mel_fmax)
            yin_gt_crop_sliced = slice_segments(
                torch.cat([out["yin_gt_crop"], out["yin_gt_shifted_crop"]], dim=0), ids,
                seg_frames)
            loss_dur = torch.sum(out["l_length"].float())
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * c.c_mel
            z_total = ratio_denominator(out["z_mask"].sum()) if ddp else None
            loss_kl = L.kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                out["z_mask"], z_total) * c.c_kl
            loss_yin_dec = (
                torch.mean(torch.abs(out["yin_gt_shifted_crop"] - out["yin_dec_crop"])) * c.c_yin
            )
            loss_yin_shift = (
                torch.mean(torch.abs(torch.exp(-yin_gt_crop_sliced)
                                     - torch.exp(-out["yin_hat_crop"]))) * c.c_yin
                + torch.mean(torch.abs(torch.exp(-out["yin_hat_shifted"])
                                       - torch.exp(-out["yin_hat_crop"][bsz:]))) * c.c_yin
            )
            loss_fm = L.feature_loss(fmap_r, fmap_g)
            loss_gen, _ = L.generator_loss(y_d_g)
            loss_total = (loss_gen + loss_fm + loss_mel + loss_dur + loss_kl + loss_yin_shift
                          + loss_yin_dec)
        with span("train.g_backward"):
            state.optim_g.zero_grad(set_to_none=True)
            loss_total.backward()
    with span("train.g_update"):
        g_metrics = torch.stack([loss_gen, loss_fm, loss_mel, loss_dur, loss_kl, loss_yin_dec,
                                 loss_yin_shift, loss_total]).detach()
        if ddp:
            g_metrics = mesh.all_mean(g_metrics)
        grad_norm_g, skipped_g = apply_update(state.optim_g, state.schedule, g_metrics[-1],
                                              nan_guard)
    state.step += 1

    names = ("score", "fm", "mel", "dur", "kl", "yindec", "yinshift", "total")
    metrics = {f"loss/g/{k}": v for k, v in zip(names, g_metrics)}
    metrics.update({
        "loss/d/total": d_metrics[0],
        "loss/d/real": d_metrics[1],
        "loss/d/gen": d_metrics[2],
        "grad_norm/g": grad_norm_g,
        "grad_norm/d": grad_norm_d,
    })
    if nan_guard:
        metrics["nan_skipped/g"] = skipped_g
        metrics["nan_skipped/d"] = skipped_d
    return {k: v.detach() for k, v in metrics.items()}
