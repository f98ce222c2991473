"""Driver of the training cells: ``vits_torch.training.step.train_step`` on
the state ``create_train_state`` makes (generator, the configuration's
discriminator, two AdamW), fed the traffic's bucketed batches with every
draw handed in (noise, PhaseAug rotations, dropout masks).

Set-up builds the program's state, loads the benchmark's seeded weights,
and runs the ``check_steps`` steps the reference follows (see
``perfbench/checks.py``), one at each of ``traffic.check_buckets``, through
the window's own call and feed. For them alone a ``SeededDropout`` stands in
for each ``nn.Dropout`` of the generator, so that the reference can draw the
same masks, and the benchmark keeps the inputs and the path of each
``maximum_path`` call. The program's own dropout is then put back, and one
step runs at each of the mix's buckets. The window runs the mix's cycle of
buckets over and over (``traffic.train_schedule``: one order for every
seed) until ``--seconds`` have passed, and drains the device.

End to end: ``train_audio_s_per_s``, the unpadded seconds of audio of every
step completed in the window (sum of ``spec_lengths`` x hop / sampling
rate) over the window's wall time.

Traced (``--trace 1``): spans around each step and around ``maximum_path``
(the module attribute the generator calls) during the window; the FLOPs of
each bucket's step counted on the reference at set-up; then a profiled
stretch of ``traced_steps`` more steps.
"""

from __future__ import annotations

import time

import torch

from perfbench import checks, device as devmod, randomness, tracing, traffic, weights
from perfbench.harness import Outcome
from perfbench.reference import flops as ref_flops
from perfbench.reference import peaks


def program_hps(cfg):
    from vits_torch.config import HParams

    return HParams(**{k: dict(cfg[k]) for k in ("train", "data", "model")})


def build_program(run, hps):
    """The program's train state on the run's device, with the benchmark's
    weights and dropout."""
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.training.step import create_train_state
    from vits_torch.training.train import build_discriminator

    dev = run.device
    bf16 = bool(hps.train.get("bf16_run", False))
    with torch.device(dev):
        model = build_synthesizer(hps, device=dev, bf16=bf16)
        disc = build_discriminator(hps, bf16, dev)
    checks.load_both(model, disc, weights.make(checks.both_shapes(model, disc), run.seed, dev))
    drops = randomness.install_dropout(model, dev)
    state = create_train_state(model, disc, hps, steps_per_epoch=int(run.traffic.steps_per_epoch))
    return state, drops


def step_noise(run, hps, bucket: int, tag) -> dict:
    m = hps.model
    return randomness.train_noise(
        int(run.traffic.batch), int(run.traffic.text_pad), bucket,
        m.inter_channels - m.yin_channels, m.yin_channels, m.yin_shift_range,
        randomness.subseed(run.seed, "noise", tag), run.device)


def first_grads(optim, module) -> dict[str, float]:
    """Each leaf's gradient norm of the first update, from AdamW's state
    after it: exp_avg = (1 - beta1) g."""
    b1 = optim.param_groups[0]["betas"][0]
    return {n: float(optim.state[p]["exp_avg"].norm()) / (1.0 - b1)
            for n, p in module.named_parameters()}


def run(run):
    from vits_torch.training.step import train_step
    import vits_torch.models.synthesizer as synthesizer

    dev, tr = run.device, run.traffic
    hps = program_hps(run.config)
    feed = traffic.TrainFeed(tr, hps.data, run.seed, dev)
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    state, drops = build_program(run, hps)

    def step(bucket: int, tag):
        batch = feed.batch(bucket, tag)
        noise = step_noise(run, hps, bucket, tag)
        randomness.reseed_dropout(drops, run.seed, tag)
        return train_step(state, batch, hps, noise=noise), batch

    # -- set-up: the checked steps, then one step at each bucket -------------
    buckets = traffic.train_buckets(tr)
    checked = traffic.check_buckets(tr)
    seen = {"losses": [], "drops": sorted(drops), "mas": []}

    def keep_path(args, kwargs, path, t0, t1):
        neg, mask = args[0], args[1]
        seen["mas"].append((neg.detach().float().cpu(), mask.detach().cpu() > 0,
                            path.detach().cpu() > 0))

    undo_keep = tracing.wrap(synthesizer, "maximum_path", "mas_check", tracing.Spans(),
                             on_call=keep_path)
    for k, bucket in enumerate(checked):
        metrics, _ = step(bucket, ("check", k))
        seen["losses"].append((float(metrics["loss/g/total"]), float(metrics["loss/d/total"])))
        if k == 0:
            seen["grads"] = {**{"g." + n: v for n, v in first_grads(state.optim_g, state.model).items()},
                             **{"d." + n: v for n, v in first_grads(state.optim_d, state.disc).items()}}
    undo_keep()
    seen["deltas"] = checks.param_deltas(state.model, state.disc, run.seed, dev)
    randomness.restore_dropout(state.model)
    drops.clear()
    for bucket in buckets:
        step(bucket, ("warm", bucket))
    devmod.sync(dev)

    flops = {}
    undo = []
    spans = tracing.Spans()
    if run.trace:
        meta_models = checks.build_reference(hps, "meta")
        flops = {b: ref_flops_of(run, hps, b, meta_models) for b in buckets}
        del meta_models
        undo.append(tracing.wrap(synthesizer, "maximum_path", "mas", spans))
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
        layer["trace"] = out_trace
        for u in undo:
            u()
    memory_peak = max(setup_peak, devmod.peak_bytes(dev))

    # -- correctness, once the program's state is gone -----------------------
    del state
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    results = checks.train_reference(run, hps, feed, seen, lambda b, t: step_noise(run, hps, b, t),
                                     checked)
    return Outcome(
        e2e={"train_audio_s_per_s": audio_frames * hop / sr / window_s},
        attempted=done, failed=0, checks=results, layer=layer,
        memory_peak_bytes=memory_peak,
        busy_s=out_trace.get("busy_s"), window_s=out_trace.get("window_s"),
        breakdown={k: out_trace[k] for k in ("device_ops", "idle_gaps") if k in out_trace},
    )


def ref_flops_of(run, hps, bucket: int, models) -> float:
    """The FLOPs of one step at ``bucket``, counted on the reference built on
    the ``meta`` device."""
    from perfbench.reference import step as ref_step

    g, d = models
    tr = run.traffic
    b, t_x = int(tr.batch), int(tr.text_pad)
    m = hps.model
    meta = torch.device("meta")
    batch = {
        "x": torch.empty((b, t_x), dtype=torch.long, device=meta),
        "t": torch.empty((b, t_x), dtype=torch.long, device=meta),
        "x_lengths": torch.empty((b,), dtype=torch.long, device=meta),
        "spec": torch.empty((b, bucket, hps.data.filter_length // 2 + 1), device=meta),
        "spec_lengths": torch.empty((b,), dtype=torch.long, device=meta),
        "ying": torch.empty((b, bucket, hps.data.midis), device=meta),
        "wav": torch.empty((b, bucket * hps.data.hop_length, 1), device=meta),
        "sid": torch.empty((b,), dtype=torch.long, device=meta),
    }
    cpu_noise = randomness.train_noise(1, 1, 1, 1, 1, 1, 0, "cpu")
    shapes = {"eps_spec": (b, bucket, m.inter_channels - m.yin_channels),
              "eps_yin": (b, bucket, m.yin_channels), "scope_shift": (b,), "e_q": (b, t_x, 2),
              "slice_u": (b,), "phi_d": (2 * b, cpu_noise["phi_d"].shape[1]),
              "phi_g": (2 * b, cpu_noise["phi_g"].shape[1])}
    noise = {k: torch.empty(s, dtype=cpu_noise[k].dtype, device=meta) for k, s in shapes.items()}
    return float(ref_flops.count(lambda: ref_step.train_step(g, d, None, None, batch, hps, noise)))
