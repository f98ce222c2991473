#!/usr/bin/env python3
"""Where the time goes in the port's slice on one NVIDIA card.

Runs vits_torch's SynthesizerTrn at the full width and depth of
configs/config_cje.yaml (random weights from --seed) on the same synthetic
batch as chip_smoke.py, and reports for the training forward (B=16 x 400
frames, no_grad, train mode) and for infer at batch 1 and 8
(max_frames=1000):

  * wall time (host clock around synchronized runs, mean of --iters);
  * device time per top-level submodule, from CUDA events recorded around
    its forward / reverse / hier_forward (the rest: MAS, neg-cross-entropy,
    yingram, glue);
  * kernel time by name and the device's idle share over one profiled run
    (torch.profiler; idle = 1 - summed kernel time / wall time).

With --train it profiles training/step.py::train_step instead (the CJE
generator and the flagship Avocodo discriminator, B=16 x 400 frames,
segment 8192), under the config's bf16 policy and in f32: wall time, the
device time between the step's phase boundaries (G forward, D step, G loss,
G backward, the two optimizers; CUDA events from module, backward and
optimizer hooks), kernel time by name and the idle share.

    python3 tools/profile_torch_slice.py [--seed N] [--iters N] [--train]

Needs a CUDA device. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the synthetic batch)


def wall_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def module_breakdown(model, fn):
    """Device ms inside each top-level child's forward / reverse /
    hier_forward, from CUDA events recorded around the calls."""
    events = []
    wrapped = []
    for name, child in model.named_children():
        for meth in ("forward", "reverse", "hier_forward"):
            if not hasattr(child, meth):
                continue
            orig = getattr(child, meth)

            def timed(*a, _orig=orig, _name=name, **k):
                ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                ev0.record()
                out = _orig(*a, **k)
                ev1.record()
                events.append((_name, ev0, ev1))
                return out

            setattr(child, meth, timed)
            wrapped.append((child, meth))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        for child, meth in wrapped:
            delattr(child, meth)
    total = start.elapsed_time(end)
    per = defaultdict(float)
    for name, ev0, ev1 in events:
        per[name] += ev0.elapsed_time(ev1)
    per["(rest: MAS, neg-cross-entropy, yingram, glue)"] = total - sum(per.values())
    return total, dict(per)


def kernel_profile(fn):
    """Summed device time per kernel name (us) and wall ms of one run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = defaultdict(float)
    for evt in prof.events():
        # user annotations (an optimizer's step) span kernels already counted
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            per[evt.name] += evt.time_range.elapsed_us()
    return dict(per), wall


def report(card, label, model, fn, iters):
    ms = wall_ms(fn, iters)
    total, per_module = module_breakdown(model, fn)
    kernels, wall = kernel_profile(fn)
    busy = sum(kernels.values()) / 1e3
    print(f"{card} | {label}: wall {ms:.3f} ms (mean of {iters}); device span "
          f"{total:.3f} ms; profiled run wall {wall:.3f} ms, kernel time {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}")
    for name, t in sorted(per_module.items(), key=lambda kv: -kv[1]):
        print(f"{card} | {label}   module {name}: {t:.3f} ms ({100 * t / total:.1f}%)")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{card} | {label}   kernel {us / 1e3:.3f} ms ({100 * us / 1e3 / busy:.1f}%) "
              f"{name[:110]}")


# the train step's phase boundaries, in the order they occur, and the phase
# each interval between two of them belongs to
STEP_SEGMENTS = (
    ("setup: batch to the card, noise draws", "setup"),
    ("G forward", "G forward"),
    ("D forward: mel, PhaseAug, D, D loss", "D step"),
    ("D backward", "D step"),
    ("D gradient norm, lr", "optimizers"),
    ("optim_d.step", "optimizers"),
    ("G loss: PhaseAug, D, mel, losses", "G loss"),
    ("G backward", "backward"),
    ("G gradient norm, lr", "optimizers"),
    ("optim_g.step", "optimizers"),
    ("metrics", "setup"),
)


def step_breakdown(state, fn):
    """Device ms between the phase boundaries of one train step, from CUDA
    events recorded by hooks on the generator, Tensor.backward and both
    optimizers."""
    events = []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    hooks = [state.model.register_forward_pre_hook(mark),
             state.model.register_forward_hook(mark)]
    for optim in (state.optim_d, state.optim_g):
        hooks += [optim.register_step_pre_hook(mark), optim.register_step_post_hook(mark)]
    backward = torch.Tensor.backward

    def marked_backward(self, *a, **k):
        mark()
        backward(self, *a, **k)
        mark()

    torch.Tensor.backward = marked_backward
    try:
        mark()
        fn()
        mark()
        torch.cuda.synchronize()
    finally:
        torch.Tensor.backward = backward
        for h in hooks:
            h.remove()
    if len(events) != len(STEP_SEGMENTS) + 1:
        raise RuntimeError(f"{len(events)} phase boundaries, expected {len(STEP_SEGMENTS) + 1}")
    return [(name, phase, a.elapsed_time(b))
            for (name, phase), a, b in zip(STEP_SEGMENTS, events, events[1:])]


def report_train(card, hps, batch, seed, iters, bf16):
    from vits_torch.models.avocodo import AvocodoDiscriminator
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.training.step import create_train_state, train_step

    label = f"train step {'bf16' if bf16 else 'f32'} B=16 T_y=400"
    torch.manual_seed(seed)
    state = create_train_state(
        build_synthesizer(hps, bf16=bf16),
        AvocodoDiscriminator(bf16=bf16, segment_size=hps.train.segment_size), hps,
        steps_per_epoch=100,
    )
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = batch
    tb = dict(x=b["x"], t=b["t"], x_lengths=b["x_lengths"], spec=b["y"],
              spec_lengths=b["y_lengths"], ying=b["ying"], wav=b["wav"], sid=b["sid"])

    def step():
        return train_step(state, tb, hps, generator=gen)

    step()  # warm-up
    ms = wall_ms(step, iters)
    segments = step_breakdown(state, step)
    kernels, wall = kernel_profile(step)
    busy = sum(kernels.values()) / 1e3
    total = sum(t for _, _, t in segments)
    print(f"{card} | {label}: wall {ms:.3f} ms (mean of {iters}); device span {total:.3f} ms; "
          f"profiled run wall {wall:.3f} ms, kernel time {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}")
    phases = defaultdict(float)
    for name, phase, t in segments:
        phases[phase] += t
        print(f"{card} | {label}   segment {name}: {t:.3f} ms ({100 * t / total:.1f}%)")
    for phase, t in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"{card} | {label}   phase {phase}: {t:.3f} ms ({100 * t / total:.1f}%)")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{card} | {label}   kernel {us / 1e3:.3f} ms ({100 * us / 1e3 / busy:.1f}%) "
              f"{name[:110]}")
    del state
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true", help="profile the GAN train step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 2
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.text.symbols import symbols
    from vits_torch.utils.profiling import card_name

    card = card_name()
    hps = load_hparams(str(ROOT / "configs" / "config_cje.yaml"))
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    b = chip_smoke.synthetic_batch(hps, rng, dev)
    if args.train:
        for bf16 in (True, False):
            report_train(card, hps, b, args.seed, args.iters, bf16)
        return 0
    torch.manual_seed(args.seed)
    model = build_synthesizer(hps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    model.train()
    with torch.no_grad():
        report(card, "forward B=16 T_y=400", model,
               lambda: model(b["x"], b["t"], b["x_lengths"], b["y"], b["y_lengths"],
                             b["ying"], b["sid"], generator=gen), args.iters)
    model.eval()
    for bsz in (1, 8):
        x = torch.from_numpy(rng.integers(1, len(symbols), (bsz, 191))).to(dev)
        t = torch.from_numpy(rng.integers(0, 6, (bsz, 191))).to(dev)
        xl = torch.from_numpy(np.full(bsz, 191) if bsz == 1 else rng.integers(129, 192, bsz)).to(dev)
        sid = torch.from_numpy(rng.integers(0, len(hps.data.speakers), bsz)).to(dev)
        with torch.no_grad():
            report(card, f"infer batch {bsz}", model,
                   lambda: model.infer(x, t, xl, sid, generator=gen, max_frames=1000),
                   args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
