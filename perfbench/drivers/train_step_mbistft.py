"""Driver of the pitchless training cell (``ljs_mbistft.train``):
``vits_torch.training.step.train_step`` on the state ``create_train_state``
makes from the configuration's generator (MB-iSTFT-VITS) and
``build_discriminator``'s discriminator (VITS's MPD + MSD), fed the traffic's
bucketed batches with every draw handed in (the posterior sample, the SDP's
noise, the slice offsets, the dropout masks).

The feed (``PitchlessFeed``) makes ``train_step.py``'s synthetic waveform
(two harmonics of a pitch drawn from 90-300 Hz plus noise, cut at each
item's length) and its linear spectrogram; no Yingram, language ids or
speaker ids. The schedule and the items' lengths are ``perfbench/traffic.py``'s.

Set-up builds the program's state, loads the benchmark's seeded weights, and
runs the ``check_steps`` steps the reference follows, one at each of
``traffic.check_buckets``, through the window's own call and feed, with a
``SeededDropout`` in place of each ``nn.Dropout`` of the generator and the
inputs and path of each ``maximum_path`` call kept. The program's own dropout
is then put back, and one step runs at each of the mix's buckets. The window
runs the mix's cycle of buckets over and over until ``--seconds`` have
passed, and drains the device.

End to end: ``train_audio_s_per_s``, the unpadded seconds of audio of every
step completed in the window over its wall time.

Traced (``--trace 1``): spans during the window and the profiled stretch of
``traced_steps`` more steps: ``mas`` around ``maximum_path``, ``disc`` around
the discriminator's forward (the D step's and the G step's calls),
``subband_loss`` around the sub-band STFT loss and the real segment's PQMF
analysis; the FLOPs of each bucket's step counted on the reference
(``reference/mb_istft_train.py::train_step``) on the ``meta`` device.

Correctness, once the program's state is freed: the reference in float32
with TF32 off (``train_step_blocks``, ``ref_block`` rows at a time) follows
the checked steps with the same weights, batches and draws. Compared:
``g_loss_gap``, ``d_loss_gap`` and ``subband_gap`` (the largest relative gap
of a checked step's total G loss, D loss and sub-band loss), ``delta_gap`` and
``delta_gap.d`` (the median over the generator's, the discriminator's moved
leaves of each leaf's gap in its change over the checked steps, over the
larger of the reference's change of that leaf and the median leaf's; a leaf
moves where its reference first gradient is at least a thousandth of the
median leaf's), ``delta_worst`` and ``delta_worst.d`` (the largest of those
gaps: a leaf whose update is lost reads 1), ``mas_path_off`` and
``dropout_sites`` (exact; as ``perfbench/checks.py``). The run's log names
the three worst leaves of each side.

``run(run, bf16=True)`` is the control (the program's step under bfloat16
autocast); ``run(run, fault=...)`` a fault of the checked steps: ``half``
(the first half of each batch's rows), ``dfrozen`` (D's update undone),
``nosubband`` (the sub-band loss left out of the G loss). ``perfbench/
control_mbistft.py`` reads them.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import sys
import time

import torch

from perfbench import checks, device as devmod, randomness, tracing, traffic, weights
from perfbench.drivers.train_step import first_grads, program_hps
from perfbench.harness import Check, Outcome
from perfbench.reference import flops as ref_flops
from perfbench.reference import peaks, precision
from perfbench.reference import step as ref_step

FAULTS = ("half", "dfrozen", "nosubband")


def make_weights(shapes: dict, seed: int, device) -> dict:
    """``weights.make`` for leaves of any rank: a leaf of more than three axes
    (a ``Conv2d`` weight) is drawn as [out, in, the rest's product], the
    same fan-in and the same place in the draw, and reshaped."""
    flat = {k: (*s[:2], math.prod(s[2:])) if len(s) > 3 else s for k, s in shapes.items()}
    return {k: v.reshape(shapes[k]) for k, v in weights.make(flat, seed, device).items()}


@torch.no_grad()
def param_deltas(g, d, seed: int, device) -> dict[str, float]:
    """Each leaf's norm of (now - the seeded start)."""
    start = make_weights(checks.both_shapes(g, d), seed, device)
    now = {**{f"g.{k}": p for k, p in g.named_parameters()},
           **{f"d.{k}": p for k, p in d.named_parameters()}}
    return {k: float((now[k] - start[k]).norm()) for k in now}


class PitchlessFeed:
    """A train mix's batches on ``device`` from the run's seed: ``x``,
    ``x_lengths``, ``spec`` [B, T_y, F], ``spec_lengths``, ``wav`` [B, T_y *
    hop, 1] (``traffic.TrainFeed``'s waveform and spectrogram)."""

    def __init__(self, tr, data, seed: int, device):
        self.tr, self.data, self.seed, self.device = tr, data, seed, device

    @torch.no_grad()
    def batch(self, bucket: int, tag) -> dict:
        from perfbench.reference.ops.stft import spectrogram

        tr, data, device = self.tr, self.data, self.device
        frames, ids = traffic.item_lengths(tr, bucket, self.seed, tag)
        b, t_x, hop = int(tr.batch), int(tr.text_pad), data.hop_length
        g = torch.Generator(device).manual_seed(randomness.subseed(self.seed, "batch", tag))
        n = torch.arange(bucket * hop, device=device, dtype=torch.float32)
        f0 = 90.0 + 210.0 * torch.rand((b, 1), generator=g, device=device)
        ph = 2 * math.pi * f0 * n / data.sampling_rate
        wav = 0.4 * torch.sin(ph) + 0.2 * torch.sin(2 * ph) \
            + 0.02 * torch.randn((b, n.numel()), generator=g, device=device)
        lengths = torch.as_tensor(frames, device=device)
        wav = wav * (n[None, :] < (lengths[:, None] * hop))
        spec = spectrogram(wav, data.filter_length, hop, data.win_length)
        x = torch.randint(1, int(tr.n_symbols), (b, t_x), generator=g, device=device)
        x[:, ::2] = 0  # the blanks add_blank puts between symbols
        x_lengths = torch.as_tensor(ids, device=device)
        x = x * (torch.arange(t_x, device=device)[None, :] < x_lengths[:, None])
        return {"x": x, "x_lengths": x_lengths, "spec": spec, "spec_lengths": lengths,
                "wav": wav[:, :, None], "host_frames": frames, "host_ids": ids}


def step_noise(run, hps, bucket: int, tag) -> dict:
    """Every draw of one step at the mix's batch (channels-last)."""
    b, t_x = int(run.traffic.batch), int(run.traffic.text_pad)
    g = torch.Generator(run.device).manual_seed(randomness.subseed(run.seed, "noise", tag))
    return {"eps_spec": torch.randn((b, bucket, hps.model.inter_channels), generator=g,
                                    device=run.device),
            "e_q": torch.randn((b, t_x, 2), generator=g, device=run.device),
            "slice_u": torch.rand((b,), generator=g, device=run.device)}


def build_program(run, hps):
    """The program's train state on the run's device, with the benchmark's
    weights and dropout."""
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.training.step import create_train_state
    from vits_torch.training.train import build_discriminator

    dev = run.device
    with torch.device(dev):
        model = build_synthesizer(hps, device=dev)
        disc = build_discriminator(hps, False, dev)
    w = make_weights(checks.both_shapes(model, disc), run.seed, dev)
    checks.load_both(model, disc, w)
    drops = randomness.install_dropout(model, dev)
    state = create_train_state(model, disc, hps, steps_per_epoch=int(run.traffic.steps_per_epoch))
    return state, drops


def build_reference(cfg, device):
    from perfbench.reference import mb_istft_train
    from perfbench.reference.models import mpd

    return mb_istft_train.build(cfg, device), mpd.build(cfg, device)


@contextlib.contextmanager
def _fault(kind, state, losses_mod):
    """A checked step under ``kind`` (see the module docstring)."""
    if kind == "dfrozen":
        before = [p.detach().clone() for p in state.disc.parameters()]
        yield
        with torch.no_grad():
            for p, b in zip(state.disc.parameters(), before):
                p.copy_(b)
    elif kind == "nosubband":
        real = losses_mod.subband_stft_loss
        losses_mod.subband_stft_loss = lambda y_mb, *a, **k: y_mb.new_zeros(())
        try:
            yield
        finally:
            losses_mod.subband_stft_loss = real
    else:
        yield


def run(run, bf16: bool = False, fault: str | None = None):
    # a program without the pitchless step (no sub-band loss) stops here
    from vits_torch.training import losses as program_losses
    from vits_torch.training.losses import subband_stft_loss  # noqa: F401
    from vits_torch.training.step import train_step
    import vits_torch.models.synthesizer as synthesizer

    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")
    dev, tr = run.device, run.traffic
    hps = program_hps(run.config)
    feed = PitchlessFeed(tr, hps.data, run.seed, dev)
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    state, drops = build_program(run, hps)
    autocast = (lambda: torch.autocast(dev.type, dtype=torch.bfloat16)) if bf16 \
        else contextlib.nullcontext

    def step(bucket: int, tag, rows=None):
        batch = feed.batch(bucket, tag)
        noise = step_noise(run, hps, bucket, tag)
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
            noise = {k: v[:rows] for k, v in noise.items()}
        randomness.reseed_dropout(drops, run.seed, tag)
        with autocast():
            return train_step(state, batch, hps, noise=noise), batch

    # -- set-up: the checked steps, then one step at each bucket -------------
    buckets = traffic.train_buckets(tr)
    checked = traffic.check_buckets(tr)
    seen = {"losses": [], "subband": [], "drops": sorted(drops), "mas": []}

    def keep_path(args, kwargs, path, t0, t1):
        neg, mask = args[0], args[1]
        seen["mas"].append((neg.detach().float().cpu(), mask.detach().cpu() > 0,
                            path.detach().cpu() > 0))

    undo_keep = tracing.wrap(synthesizer, "maximum_path", "mas_check", tracing.Spans(),
                             on_call=keep_path)
    rows = int(tr.batch) // 2 if fault == "half" else None
    for k, bucket in enumerate(checked):
        with _fault(fault, state, program_losses):
            metrics, _ = step(bucket, ("check", k), rows)
        seen["losses"].append((float(metrics["loss/g/total"]), float(metrics["loss/d/total"])))
        seen["subband"].append(float(metrics["loss/g/subband"]))
        if k == 0:
            seen["grads"] = {**{"g." + n: v for n, v in first_grads(state.optim_g,
                                                                   state.model).items()},
                             **{"d." + n: v for n, v in first_grads(state.optim_d,
                                                                   state.disc).items()}}
    undo_keep()
    seen["deltas"] = param_deltas(state.model, state.disc, run.seed, dev)
    randomness.restore_dropout(state.model)
    drops.clear()
    for bucket in buckets:
        step(bucket, ("warm", bucket))
    devmod.sync(dev)

    flops = {}
    undo = []
    spans = tracing.Spans()
    if run.trace:
        meta_models = build_reference(run.config, "meta")
        flops = {b: ref_flops_of(run, b, meta_models) for b in buckets}
        del meta_models
        undo += [tracing.wrap(synthesizer, "maximum_path", "mas", spans),
                 tracing.wrap(state.disc, "forward", "disc", spans),
                 tracing.wrap(program_losses, "subband_stft_loss", "subband_loss", spans),
                 tracing.wrap(state.model.waveform_decoder.pqmf, "analysis", "subband_loss",
                              spans)]
    setup_peak = devmod.peak_bytes(dev)
    devmod.reset_peak(dev)

    # -- the window --------------------------------------------------------
    run.window_opens()
    schedule = traffic.train_schedule(tr, 100000)
    audio_frames, done, work = 0, 0, 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        bucket = schedule[done]
        t_s = time.perf_counter()
        with torch.profiler.record_function("perfbench.train_step"):
            _, batch = step(bucket, ("window", done))
        spans.intervals["train_step"].append((t_s, time.perf_counter()))
        audio_frames += int(batch["host_frames"].sum())
        work += flops.get(bucket, 0.0)
        done += 1
    devmod.sync(dev)
    window_s = time.perf_counter() - t0
    peak = devmod.peak_bytes(dev)

    layer = {"steps": done, "window_s": window_s, "peak_bytes": peak}
    out_trace = {}
    if run.trace:
        layer["flops"] = work
        layer["peak_flops"] = peaks.peak_bf16_flops(torch.cuda.get_device_name(dev)) \
            if dev.type == "cuda" else None
        bounds = []

        def traced():
            for j in range(int(tr.traced_steps)):
                bucket = schedule[done + j]
                _, batch = step(bucket, ("window", done + j))
                bounds.append(peaks.mas_bound_s(batch["host_frames"], batch["host_ids"], bucket,
                                                int(tr.text_pad)))

        out_trace = tracing.profile(traced) if dev.type == "cuda" else {}
        layer["mas_bound_s"] = sum(bounds)
        layer["traced_steps"] = int(tr.traced_steps)
        layer["trace"] = out_trace
        for u in undo:
            u()
    memory_peak = max(setup_peak, devmod.peak_bytes(dev))

    # -- correctness, once the program's state is gone -----------------------
    del state
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    results = train_checks(run, feed, seen, checked)
    return Outcome(
        e2e={"train_audio_s_per_s": audio_frames * hop / sr / window_s},
        attempted=done, failed=0, checks=results, layer=layer,
        memory_peak_bytes=memory_peak,
        busy_s=out_trace.get("busy_s"), window_s=out_trace.get("window_s"),
        breakdown={k: out_trace[k] for k in ("device_ops", "idle_gaps") if k in out_trace},
    )


def ref_flops_of(run, bucket: int, models) -> float:
    """The FLOPs of one step at ``bucket``, counted on the reference built on
    the ``meta`` device."""
    from perfbench.reference import mb_istft_train

    g, d = models
    cfg = run.config
    b, t_x = int(run.traffic.batch), int(run.traffic.text_pad)
    meta = torch.device("meta")
    batch = {
        "x": torch.empty((b, t_x), dtype=torch.long, device=meta),
        "x_lengths": torch.empty((b,), dtype=torch.long, device=meta),
        "spec": torch.empty((b, bucket, cfg.data.filter_length // 2 + 1), device=meta),
        "spec_lengths": torch.empty((b,), dtype=torch.long, device=meta),
        "wav": torch.empty((b, bucket * cfg.data.hop_length, 1), device=meta),
    }
    noise = {"eps_spec": torch.empty((b, bucket, cfg.model.inter_channels), device=meta),
             "e_q": torch.empty((b, t_x, 2), device=meta),
             "slice_u": torch.empty((b,), device=meta)}
    return float(ref_flops.count(
        lambda: mb_istft_train.train_step(g, d, None, None, batch, cfg, noise)))


def reference_steps(run, feed, buckets: list[int]) -> dict:
    """The reference's losses, first gradients and changes over the checked
    steps, one at each of ``buckets``."""
    from perfbench.reference import mb_istft_train

    dev, cfg = run.device, run.config
    with precision.exact():
        g, d = build_reference(cfg, dev)
        checks.load_both(g, d, make_weights(checks.both_shapes(g, d), run.seed, dev))
        drops = randomness.install_dropout(g, dev)
        opt_g, opt_d = ref_step.make_adamw(cfg, g), ref_step.make_adamw(cfg, d)
        losses, subband = [], []
        for k, bucket in enumerate(buckets):
            tag = ("check", k)
            batch = feed.batch(bucket, tag)
            noise = step_noise(run, cfg, bucket, tag)

            def before(i, j, full, tag=tag):
                randomness.reseed_dropout(drops, run.seed, tag)
                for m in drops.values():
                    m.rows = (i, j, full)

            out = mb_istft_train.train_step_blocks(g, d, opt_g, opt_d, batch, cfg, noise,
                                                   int(run.traffic.ref_block), before)
            losses.append((out["g"], out["d"]))
            subband.append(out["subband"])
        grads = {**{"g." + n: v for n, v in opt_g.first_grads.items()},
                 **{"d." + n: v for n, v in opt_d.first_grads.items()}}
        deltas = param_deltas(g, d, run.seed, dev)
    del g, d, opt_g, opt_d
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "subband": subband, "grads": grads, "deltas": deltas,
            "drops": sorted(drops)}


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of the module docstring but the exact two."""
    def gap(p, r) -> float:
        return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p, r))

    out = {"g_loss_gap": gap([p[0] for p in prog["losses"]], [r[0] for r in ref["losses"]]),
           "d_loss_gap": gap([p[1] for p in prog["losses"]], [r[1] for r in ref["losses"]]),
           "subband_gap": gap(prog["subband"], ref["subband"])}
    for side, (median, worst) in worst_leaves(prog, ref).items():
        out[DELTA_NAMES[side][0]] = median
        out[DELTA_NAMES[side][1]] = worst[0][0] if worst else float("nan")
    return out


# each side's moved leaves: the median gap's name and the worst leaf's
DELTA_NAMES = {"g.": ("delta_gap", "delta_worst"), "d.": ("delta_gap.d", "delta_worst.d")}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """Per side (``g.``, ``d.``): the median gap of the moved leaves' changes
    and the ``n`` largest as (gap, leaf, program's change, reference's);
    NaN and none where the program's leaves are not the reference's."""
    out = {}
    moved = checks.moved_leaves(ref)
    for side in DELTA_NAMES:
        if set(prog["deltas"]) != set(ref["deltas"]):
            out[side] = (float("nan"), [])
            continue
        gaps = checks._leaf_gaps(prog["deltas"], ref["deltas"],
                                 [k for k in moved if k.startswith(side)])
        out[side] = (statistics.median(g for g, _ in gaps),
                     [(g, k, prog["deltas"][k], ref["deltas"][k]) for g, k in gaps[:n]])
    return out


def train_checks(run, feed, seen: dict, buckets: list[int]) -> list[Check]:
    try:
        ref = reference_steps(run, feed, buckets)
    except ValueError as e:  # the program's parameters are not the reference's
        print(f"perfbench: {e}", file=sys.stderr)
        return [Check("parameters_match", 1.0, 0.0)]
    nums = numbers(seen, ref)
    run.raw = {"prog": {k: v for k, v in seen.items() if k != "mas"}, "ref": ref}
    worst = "; ".join(f"{side} " + ", ".join(f"{k} {g:.4g} ({p:.4g} vs {r:.4g})"
                                             for g, k, p, r in top)
                      for side, (_, top) in worst_leaves(seen, ref).items())
    print(f"perfbench: {nums}; losses {seen['losses']} vs {ref['losses']}; sub-band "
          f"{seen['subband']} vs {ref['subband']}; median first gradient "
          f"{statistics.median(ref['grads'].values()):.4g}; worst changes {worst}",
          file=sys.stderr)
    lim = run.limits
    sites = len(set(seen["drops"]) ^ set(ref["drops"]))
    return [Check(k, float(v), float(lim[k])) for k, v in nums.items() if k in lim] + [
        Check("mas_path_off", float(checks.mas_path_off(seen["mas"])), 0.0),
        Check("dropout_sites", float(sites), 0.0)]
