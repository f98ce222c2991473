"""Training entry point (port of ``vits_tpu/training/train.py``):

    python -m vits_torch.training.train -c <yaml> -m <dir>            # one card
    torchrun --nproc_per_node N -m vits_torch.training.train \
        -c <yaml> -m <dir> --distributed                               # N cards

Behavioral reference: reference train.py + train_and_evaluate.py, through
the JAX package's loop: filelists -> cached features -> bucketed static
batches -> ``train_step``, with logging every ``log_interval`` steps,
``evaluate`` every ``eval_interval`` steps, checkpoints every
``save_interval`` steps (pruned to ``keep_ckpts``) and resume from the latest
``train_{step}``.

Differences of form, none of function:
  * the batches come from a ``torch.utils.data.DataLoader`` (worker processes,
    pinned memory); the loop copies each batch to the card one batch ahead
    of the step that uses it (``non_blocking``), where the JAX loop keeps two
    device transfers in flight;
  * randomness: the JAX step folds one base key with ``state.step``. Here
    step ``s`` draws its noise from a ``torch.Generator`` seeded from
    ``(train.seed, s)`` and PyTorch's default generator (dropout) is seeded
    from the same pair, so a resumed run draws what an unbroken run draws;
    the models' initial weights come from ``torch.manual_seed(train.seed)``;
  * ``--distributed``: one process a card under ``torchrun`` and DDP over
    NCCL (``vits_torch/parallel/mesh.py``), where the JAX package runs one
    process a host over a device mesh. ``train.batch_size`` is the global
    batch, as there: each rank's sampler takes ``batch_size / world`` rows
    (``num_replicas=world, rank=rank``), and the step computes the global
    batch's losses and gradient (``training/step.py``). Every rank draws the
    global batch's noise from the same seed and keeps its rows. Dropout:
    rank 0 seeds it as one process does and a rank r > 0 from
    ``(train.seed, s, r)``, so each rank draws its own masks and a run of
    one rank draws what the single-process run draws; JAX draws one mask a
    global row from one key, which no split of the batch over ranks can
    reproduce. Every rank loads the newest checkpoint; rank 0 alone
    evaluates, saves, writes summaries and ``train.log``, and logs the
    global metrics.

Reproduced on purpose: a checkpoint records the epoch it was saved in, not
the next one, so a resumed run starts that epoch again from its first batch
(the JAX loop's ``save_checkpoint(..., epoch)``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from vits_torch.config import get_hparams, load_hparams
from vits_torch.data.dataset import (
    DatasetConfig,
    DistributedBucketSampler,
    TextAudioSpeakerDataset,
    make_loader,
)
from vits_torch.models.avocodo import AvocodoDiscriminator, probe_discriminator
from vits_torch.models.mpd import MultiPeriodDiscriminator
from vits_torch.models.synthesizer import build_synthesizer, resolve_device
from vits_torch.ops import kernel_launches
from vits_torch.parallel import mesh
from vits_torch.training.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from vits_torch.training.evaluate import evaluate
from vits_torch.training.step import (
    TrainState,
    create_train_state,
    replicate_state,
    train_step,
)
from vits_torch.utils.logging_utils import (
    NullWriter,
    check_git_hash,
    get_logger,
    have_matplotlib,
    make_writer,
    summarize,
)
from vits_torch.utils.profiling import StepTimer, trace

DEFAULT_BOUNDARIES = [32, 300, 400, 500, 600, 700, 800, 900, 1000, 1100, 1200, 1300, 1400, 1500]


def _has_pitch(hps) -> bool:
    """Whether the configured model has the pitch path (``model.pitch`` is
    not ``none``), as ``SynthesizerTrn.has_pitch`` reads it."""
    return str((hps.get("model") or {}).get("pitch", "yingram")) != "none"


def build_dataset(hps, split: str, pt_run: bool = False):
    """The split's dataset; a pitchless model (``model.pitch: none``) reads no
    Yingram, so its data section needs no Yingram keys."""
    pitch = _has_pitch(hps)
    yin = dict(midi_start=hps.data.midi_start, midi_end=hps.data.midi_end,
               octave_range=hps.data.octave_range, tau_max=hps.data.tau_max) if pitch else {}
    cfg = DatasetConfig(
        data_path=hps.data.data_path,
        sampling_rate=hps.data.sampling_rate,
        filter_length=hps.data.filter_length,
        hop_length=hps.data.hop_length,
        win_length=hps.data.win_length,
        add_blank=hps.data.add_blank,
        min_text_len=hps.data.get("min_text_len", 1),
        max_text_len=hps.data.get("max_text_len", 190),
        speakers=tuple(hps.data.speakers),
        pitch=pitch,
        **yin,
    )
    filelist = (
        hps.data.training_files if split == "train" else hps.data.validation_files
    )
    return TextAudioSpeakerDataset(filelist, cfg, pt_run=pt_run)


def build_discriminator(hps, bf16: bool, device) -> torch.nn.Module:
    """The model's discriminator, chosen as ``train_step`` chooses its branch:
    the Avocodo CoMBD + SBD for a model with the pitch path (PITS's), VITS's
    MPD + MSD (``models/mpd.py``, MB-iSTFT-VITS's) for a pitchless one.
    ``model.discriminator_size`` (``flagship`` | ``probe``) picks the
    published widths or the test widths of either. MPD + MSD computes in
    float32, as MB-iSTFT-VITS trains, so ``bf16`` is for Avocodo alone."""
    disc_size = str(hps.model.get("discriminator_size", "flagship"))
    if disc_size not in ("flagship", "probe"):
        # a typo ('Probe', 'small') would otherwise silently train the
        # flagship discriminator and mask a misconfigured probe/CI run
        raise ValueError(
            f"model.discriminator_size must be 'flagship' or 'probe', "
            f"got {disc_size!r}"
        )
    if not _has_pitch(hps):
        if bf16:
            raise ValueError("build_discriminator: VITS's MPD + MSD of a pitchless model "
                             "computes in float32; bf16 is for the Avocodo discriminator")
        return MultiPeriodDiscriminator(probe=disc_size == "probe", device=device)
    make = probe_discriminator if disc_size == "probe" else AvocodoDiscriminator
    return make(bf16=bf16, segment_size=hps.train.segment_size, device=device)


def step_seeds(seed: int, step: int, rank: int = 0) -> tuple[int, int]:
    """(noise seed, dropout seed) of the step that starts at ``step`` on
    ``rank``: the noise seed is the same on every rank, the dropout seed of
    a rank > 0 is its own."""
    noise, dropout = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    if rank:
        dropout = np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0]
    return int(noise), int(dropout)


def _device_batches(loader, device, waits: list[float]):
    """The loader's batches on ``device``, each copy issued one batch ahead
    of the step that uses it; appends the host seconds spent waiting on the
    loader for each batch to ``waits`` (the first wait holds the start of
    the loader's workers)."""
    t0 = time.perf_counter()
    it = iter(loader)

    def fetch(t0):
        batch = next(it, None)
        if batch is None:
            return None
        waits.append(time.perf_counter() - t0)
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}

    nxt = fetch(t0)
    while nxt is not None:
        cur, nxt = nxt, fetch(time.perf_counter())
        yield cur


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _close_loader(loader) -> None:
    """Stop a loader's persistent worker processes now."""
    it = getattr(loader, "_iterator", None)
    if it is not None and hasattr(it, "_shutdown_workers"):
        it._shutdown_workers()
    loader._iterator = None


@dataclasses.dataclass
class RunReport:
    """What ``run`` did: the final state and host-clock timings (seconds)."""

    state: TrainState
    start_step: int
    start_epoch: int
    step_s: list[float]       # StepTimer intervals (evaluation and saves left out)
    data_wait_s: list[float]  # host wait on the loader, one a batch
    first_metrics: dict
    last_metrics: dict
    evals: list[dict]         # {"step", "s", "scalars"}
    checkpoints: list[dict]   # {"step", "s", "bytes": {path: size}}


def run(hps, initial_run: bool = False, device=None) -> RunReport:
    """Train on ``device`` (``cuda`` unless it names another); inside a
    process group (``parallel.mesh.init_distributed``), as one of its ranks."""
    device = resolve_device(device)
    rank, world = mesh.process_index(), mesh.process_count()
    lead = rank == 0
    if lead:
        logger = get_logger(hps.model_dir)
        check_git_hash(hps.model_dir, logger)
        writer = make_writer(hps.model_dir, logger)
        if not have_matplotlib():
            logger.warning("no spectrogram images are summarized: matplotlib does not import")
    else:  # no train.log, no summaries: warnings reach stderr
        logger = logging.getLogger(f"vits_torch.train.rank{rank}")
        writer = NullWriter()

    train_ds = build_dataset(hps, "train", pt_run=initial_run)
    val_ds = build_dataset(hps, "val")
    boundaries = list(hps.data.get("bucket_boundaries", DEFAULT_BOUNDARIES))
    # train.batch_size is the global batch; each rank feeds its share
    batch_size = mesh.local_batch_rows(hps.train.batch_size)
    sampler = DistributedBucketSampler(
        train_ds.lengths, batch_size, boundaries, num_replicas=world, rank=rank, shuffle=True,
    )
    text_bound = 2 * hps.data.get("max_text_len", 190) + 4
    pin = device.type == "cuda"
    train_loader = make_loader(train_ds, sampler, text_bound, pin_memory=pin)
    val_sampler = DistributedBucketSampler(
        val_ds.lengths, min(batch_size, max(len(val_ds), 1)), boundaries,
        num_replicas=1, rank=0, shuffle=False,
    )
    val_loader = make_loader(val_ds, val_sampler, text_bound, pin_memory=pin) if lead else None

    bf16 = bool(hps.train.get("bf16_run", False))
    torch.manual_seed(hps.train.seed)
    model = build_synthesizer(hps, device=device, bf16=bf16)
    disc = build_discriminator(hps, bf16, device)
    steps_per_epoch = max(len(sampler), 1)
    state = create_train_state(model, disc, hps, steps_per_epoch)

    epoch_start = 0
    ckpt = latest_checkpoint(hps.model_dir)
    if ckpt is not None:
        state, epoch_start = load_checkpoint(ckpt, state)
        logger.info("resumed from %s (epoch %d)", ckpt, epoch_start)
    if mesh.is_distributed():
        replicate_state(state, hps)
        logger.info("data parallel over %d process(es) (%s), global batch %d (%d a rank)",
                    world, device, hps.train.batch_size, batch_size)

    global_step = state.step
    report = RunReport(state, global_step, epoch_start, [], [], {}, {}, [], [])
    timer = StepTimer()
    profile_at = int(hps.train.get("profile_step", 0))  # 0 = off
    log_interval = hps.train.log_interval
    eval_interval = hps.train.eval_interval
    save_interval = hps.train.get("save_interval", 200)
    gen = torch.Generator(device)
    metrics = None

    try:
        for epoch in range(epoch_start, hps.train.epochs):
            sampler.set_epoch(epoch)
            t_epoch = time.time()
            for batch in _device_batches(train_loader, device, report.data_wait_s):
                noise_seed, dropout_seed = step_seeds(hps.train.seed, state.step, rank)
                gen.manual_seed(noise_seed)
                torch.manual_seed(dropout_seed)
                if profile_at and global_step == profile_at:
                    # one traced step, viewable in Perfetto / chrome://tracing
                    with trace(hps.model_dir):
                        metrics = train_step(state, batch, hps, generator=gen)
                        _sync(device)
                else:
                    metrics = train_step(state, batch, hps, generator=gen)
                global_step += 1
                timer.tick()
                if not report.first_metrics:
                    report.first_metrics = {k: float(v) for k, v in metrics.items()}

                if global_step % log_interval == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars["learning_rate"] = float(state.schedule(global_step))
                    scalars["perf/steps_per_sec"] = timer.steps_per_sec()
                    summarize(writer, global_step, scalars=scalars)
                    logger.info(
                        "step %d | g %.4f d %.4f",
                        global_step,
                        scalars["loss/g/total"],
                        scalars["loss/d/total"],
                    )
                if global_step % eval_interval == 0 and lead:
                    _sync(device)
                    t0 = time.perf_counter()
                    scalars = evaluate(model, val_loader, writer, global_step, hps)
                    report.evals.append({"step": global_step, "s": time.perf_counter() - t0,
                                         "scalars": scalars})
                    timer.restart()
                if global_step % save_interval == 0 and lead:
                    _sync(device)
                    t0 = time.perf_counter()
                    sizes = save_checkpoint(
                        hps.model_dir, global_step, state, epoch,
                        keep_ckpts=hps.train.get("keep_ckpts", 3),
                    )
                    report.checkpoints.append({"step": global_step, "bytes": sizes,
                                               "s": time.perf_counter() - t0})
                    logger.info("saved checkpoint at step %d", global_step)
                    timer.restart()
            logger.info(
                "epoch %d done in %.1fs (%d steps)",
                epoch, time.time() - t_epoch, len(sampler),
            )
        if mesh.is_distributed():
            dist.barrier()  # the ranks leave together, rank 0's files written
    finally:
        _close_loader(train_loader)
        if val_loader is not None:
            _close_loader(val_loader)
        writer.close()
    if metrics is not None:
        report.last_metrics = {k: float(v) for k, v in metrics.items()}
    report.step_s = list(timer.times)
    logger.info(
        "run done at step %d; step intervals %s ms; kernel launches in this process %s%s",
        state.step, ", ".join(f"{t * 1e3:.2f}" for t in report.step_s), kernel_launches(),
        f"; peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
        if device.type == "cuda" else "",
    )
    return report


def main(argv=None) -> RunReport:
    parser = argparse.ArgumentParser(description="train vits_torch on one card or, under "
                                     "torchrun with --distributed, on several")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-m", "--model", required=True, help="model dir name")
    parser.add_argument(
        "-i", "--initial-run", action="store_true",
        help="precompute all feature caches first",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="data parallel, one process a card under torchrun: DDP over NCCL "
        "(gloo with --device cpu)",
    )
    parser.add_argument("--device", default=None,
                        help="default: cuda (cuda:LOCAL_RANK with --distributed)")
    args = parser.parse_args(argv)
    if not args.distributed:
        return run(get_hparams(args.config, args.model), initial_run=args.initial_run,
                   device=args.device)
    device = mesh.init_distributed(args.device)
    try:
        if mesh.process_index() == 0:
            hps = get_hparams(args.config, args.model)  # snapshots the config
        else:
            hps = load_hparams(args.config)
            hps.model_dir = args.model
        return run(hps, initial_run=args.initial_run, device=device)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main()
