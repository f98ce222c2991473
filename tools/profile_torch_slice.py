#!/usr/bin/env python3
"""Where the time goes in the port's slice on one NVIDIA card.

Runs vits_torch's SynthesizerTrn at the full width and depth of
configs/config_cje.yaml, or of --config (random weights from --seed), on the
same synthetic batch as chip_smoke.py, and reports for the training forward
(B=16 x 400 frames, no_grad, train mode; not for a model without the pitch
path) and for infer at batch 1 and 8 (max_frames=1000):

  * wall time (host clock around synchronized runs, mean of --iters);
  * device time per top-level submodule, from CUDA events recorded around
    its forward / reverse / hier_forward (the rest: MAS, neg-cross-entropy,
    yingram, glue);
  * kernel time by name and the device's idle share over one profiled run
    (torch.profiler; idle = 1 - the union of kernel, copy and memset
    intervals / the run's wall time);
  * for each of the port's spans open in that run (utils/profiling.py:
    ``vits.decode`` around the decoder, ``vits.decode.istft`` around an
    iSTFT decoder's head), the device time of the kernels launched while it
    was the innermost span, its host time and the device's idle time in it.

With --train it profiles training/step.py::train_step instead (the CJE
generator and the flagship Avocodo discriminator, B=16 x 400 frames,
segment 8192), under the config's bf16 policy and in f32: wall time, for
each of the step's own spans (utils/profiling.py: inputs, G forward, MAS, D
forward, D backward, D update, G loss, G backward, G update) the device
time of the kernels launched in it, its host time and the device's idle
time while it was open (``reduce_spans``, below), kernel time by name and
the idle share.

    python3 tools/profile_torch_slice.py [--seed N] [--iters N] [--train] [--config PATH]

Needs a CUDA device. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the synthetic batch)
from perfbench.tracing import DEVICE_CATS, LAUNCH_CATS, _union  # noqa: E402

SPAN_PREFIX = "vits."


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


def _innermost(spans: list[tuple[float, float, str]]) -> tuple[list[float], list]:
    """Times ``t_i`` and names ``n_i``: from ``t_i`` until ``t_{i+1}`` the
    innermost (latest opened) of ``spans`` open is ``n_i`` (None: none)."""
    marks = sorted([(b, 0, i) for i, (a, b, _) in enumerate(spans)]
                   + [(a, 1, i) for i, (a, b, _) in enumerate(spans)])
    active: set[int] = set()
    times: list[float] = []
    names: list = []
    for t, opens, i in marks:
        (active.add if opens else active.discard)(i)
        inner = max(active, key=lambda j: (spans[j][0], -spans[j][1]), default=None)
        name = None if inner is None else spans[inner][2]
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)
    return times, names


def _at(table, t: float):
    times, names = table
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def _pieces(table, a: float, b: float):
    """(name, length) of each piece of [a, b) that ``table`` (of
    ``_innermost``) gives one name."""
    times, names = table
    i = bisect.bisect_right(times, a) - 1
    while a < b:
        end = min(b, times[i + 1]) if i + 1 < len(times) else b
        yield (names[i] if i >= 0 else None), end - a
        a, i = end, i + 1


def reduce_spans(events: list[dict], window: str) -> dict:
    """The port's spans (``vits_torch/utils/profiling.py``) in a Chrome trace
    (``export_chrome_trace``'s ``traceEvents``, times in microseconds), over
    the stretch of the first annotation named ``window``; the device's
    intervals as ``perfbench/tracing.py::reduce_trace`` takes them:

    - ``window_s``; ``busy_s``, the union of the kernel, copy and memset
      intervals inside it; ``idle_s`` = ``window_s`` - ``busy_s``;
    - ``spans``, for each ``vits.*`` name: ``count`` and ``host_s`` (its
      intervals), ``device_s`` (the device time of the launches made while
      it was the innermost ``vits.*`` span open on the launching thread; a
      thread with none open, as autograd's device thread in a backward,
      takes the innermost open on any thread, the one that called the
      backward) and ``idle_s`` (the window's idle time while it was the
      innermost ``vits.*`` span open on any thread);
    - ``idle_outside_s``: the idle time with no ``vits.*`` span open, so
      that the ``idle_s`` of the spans and it add up to the window's.

    Empty where the trace has no such window."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next((e for e in xs if e.get("name") == window), None)
    if win is None:
        return {}
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    by_corr: dict = defaultdict(float)
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr[corr] += float(e["dur"])
    busy_us, merged = _union([
        (max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in device
        if max(float(e["ts"]), w0) < min(float(e["ts"]) + float(e["dur"]), w1)])
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))

    marks = [e for e in xs if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in marks]
    anywhere = _innermost(ivs)
    per_thread = {tid: _innermost([iv for iv, e in zip(ivs, marks) if e.get("tid") == tid])
                  for tid in {e.get("tid") for e in marks}}
    out: dict = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
    for a, b, name in ivs:
        out[name]["count"] += 1
        out[name]["host_s"] += (b - a) * 1e-6
    for e in xs:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        dev = by_corr.get((e.get("args") or {}).get("correlation"), 0.0)
        if not dev:
            continue
        t = float(e["ts"])
        table = per_thread.get(e.get("tid"))
        name = (_at(table, t) if table else None) or _at(anywhere, t)
        if name is not None:
            out[name]["device_s"] += dev * 1e-6
    outside = 0.0
    for a, b in gaps:
        for name, us in _pieces(anywhere, a, b):
            if name is None:
                outside += us
            else:
                out[name]["idle_s"] += us * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "idle_s": (w1 - w0 - busy_us) * 1e-6, "spans": dict(out),
            "idle_outside_s": outside * 1e-6}


WINDOW = "profile_torch_slice.run"


def kernel_profile(fn):
    """Summed device time per kernel name (us) of one profiled run, and the
    run's trace reduced by ``reduce_spans``."""
    from torch.profiler import ProfilerActivity, profile

    from vits_torch.utils.profiling import set_tracing

    torch.cuda.synchronize()
    was = set_tracing(True)  # the port's spans on the trace
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
    finally:
        set_tracing(was)
    per = defaultdict(float)
    for evt in prof.events():
        # user annotations (an optimizer's step) span kernels already counted
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            per[evt.name] += evt.time_range.elapsed_us()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return dict(per), reduce_spans(events, WINDOW)


def run_line(kernels, run) -> str:
    busy = sum(kernels.values()) / 1e3
    return (f"profiled run wall {run['window_s'] * 1e3:.3f} ms, kernel time {busy:.3f} ms, "
            f"idle share {run['idle_s'] / run['window_s']:.3f}")


def report(card, label, model, fn, iters):
    ms = wall_ms(fn, iters)
    total, per_module = module_breakdown(model, fn)
    kernels, run = kernel_profile(fn)
    busy = sum(kernels.values()) / 1e3
    print(f"{card} | {label}: wall {ms:.3f} ms (mean of {iters}); device span "
          f"{total:.3f} ms; {run_line(kernels, run)}")
    for name, t in sorted(per_module.items(), key=lambda kv: -kv[1]):
        print(f"{card} | {label}   module {name}: {t:.3f} ms ({100 * t / total:.1f}%)")
    for name, sp in sorted(run["spans"].items(), key=lambda kv: -kv[1]["device_s"]):
        print(f"{card} | {label}   span {name}: device {sp['device_s'] * 1e3:.3f} ms (innermost), "
              f"host {sp['host_s'] * 1e3:.3f} ms, device idle {sp['idle_s'] * 1e3:.3f} ms")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{card} | {label}   kernel {us / 1e3:.3f} ms ({100 * us / 1e3 / busy:.1f}%) "
              f"{name[:110]}")


# the train step's spans (vits_torch/training/step.py) in the order they
# open, and the phase each belongs to
STEP_SPANS = (
    ("vits.train.inputs", "setup"),
    ("vits.train.g_forward", "G forward"),
    ("vits.mas", "G forward"),
    ("vits.train.d_forward", "D step"),
    ("vits.train.d_backward", "D step"),
    ("vits.train.d_update", "optimizers"),
    ("vits.train.g_loss", "G loss"),
    ("vits.train.g_backward", "backward"),
    ("vits.train.g_update", "optimizers"),
)


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
    kernels, run = kernel_profile(step)
    busy = sum(kernels.values()) / 1e3
    spans = run["spans"]
    total = sum(s["device_s"] for s in spans.values()) * 1e3
    print(f"{card} | {label}: wall {ms:.3f} ms (mean of {iters}); device time in spans "
          f"{total:.3f} ms; {run_line(kernels, run)}")
    phases = defaultdict(float)
    for name, phase in STEP_SPANS:
        s = spans[name]
        t = s["device_s"] * 1e3
        phases[phase] += t
        print(f"{card} | {label}   segment {name}: {t:.3f} ms ({100 * t / total:.1f}%); host "
              f"{s['host_s'] * 1e3:.3f} ms, device idle {s['idle_s'] * 1e3:.3f} ms")
    print(f"{card} | {label}   device idle outside the spans "
          f"{run['idle_outside_s'] * 1e3:.3f} ms")
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
    ap.add_argument("--config", default=str(ROOT / "configs" / "config_cje.yaml"),
                    help="the model's configuration (YAML or JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: needs a CUDA device", file=sys.stderr)
        return 2
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.text.symbols import symbols
    from vits_torch.utils.profiling import card_name

    card = card_name()
    hps = load_hparams(args.config)
    pitch = str(hps.model.get("pitch", "yingram")) != "none"
    if args.train and not pitch:
        print("profile_torch_slice: --train needs a model with the pitch path", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    b = chip_smoke.synthetic_batch(hps, rng, dev) if pitch else None
    if args.train:
        for bf16 in (True, False):
            report_train(card, hps, b, args.seed, args.iters, bf16)
        return 0
    torch.manual_seed(args.seed)
    model = build_synthesizer(hps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if pitch:
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
        sid = (torch.from_numpy(rng.integers(0, len(hps.data.speakers), bsz)).to(dev)
               if hps.data.speakers else None)
        with torch.no_grad():
            report(card, f"infer batch {bsz}", model,
                   lambda: model.infer(x, t, xl, sid, generator=gen, max_frames=1000),
                   args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
