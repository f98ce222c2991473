"""Profiling / tracing hooks (port of ``vits_tpu/utils/profiling.py``): a
``torch.profiler`` trace of host and device activity exported as a Chrome
trace (Perfetto, chrome://tracing), the port's own spans and counters, a
lightweight step timer whose summaries land in the training log and
TensorBoard, and what the benchmark scripts (``bench*_torch.py``) need to
state a model FLOP utilisation: the card's name and power limit, its dense
bf16 peak, and a step's FLOPs.

Spans and counters. ``span(name)`` marks a phase of the port (the train
step's phases, the engine's g2p, noise, infer, sync and copy, ``mas``) and
``count(name, n)`` adds to a counter (the engine's requests, infer calls,
escalations, frames decoded and kept). A span is live while the switch
(``set_tracing``) is on, as inside ``trace()``; a counter also while any
``torch.profiler`` records. A span does not turn itself on under another
profile: it would put its marks, and their host cost, into a profile that
did not ask for them (a traced benchmark stretch read several points more
idle with them). Off, the default, a span is one shared no-op context (no
profiler call, no clock read, no allocation) and a count does nothing. On,
a span opens
``torch.profiler.record_function("vits." + name)``, so it lies on the
profiler's timeline with the kernels it launches, and adds its host
interval (``time.perf_counter``) to an in-process aggregate of calls and
seconds per span; ``snapshot()`` reads the aggregate and the counters,
``reset()`` clears them.

``step_flops`` takes the place of ``tools/hlo_flops.py`` (the JAX package
counts the FLOPs of the compiled HLO's convolutions and dots): it counts the
aten matmuls and convolutions one call dispatches, with
``torch.utils.flop_counter.FlopCounterMode``. A convolution's data gradient
and weight gradient each cost its forward's multiply-adds. PyTorch's own
backward formula counts a grouped convolution's weight gradient as if the
convolution were dense (``groups`` times too many); ``conv_backward_flops``
counts it once, as ``hlo_flops.py`` does for a ``batch_group_count``
convolution. FFTs, elementwise work and the MAS kernel (a ``ctypes`` launch)
are not counted, as the HLO count skips FFTs, fusions and the Pallas call."""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

# dense bf16 tensor-core peak in FLOP/s, by the card's name (NVIDIA H100 SXM
# data sheet, at 700 W); any other card, and the CPU, has none here
_PEAK_BF16_FLOPS = (("H100 80GB HBM3", 989e12), ("H100 SXM", 989e12))


def card_name() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peak_bf16_flops(name: str) -> float | None:
    """Dense bf16 peak FLOP/s of the card ``name`` names, else None."""
    for key, peak in _PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``: the forward's for each
    gradient asked for (input, weight), grouped or not."""
    forward = conv_flop_count(list(x_shape), list(w_shape), list(grad_out_shape), transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def step_flops(fn) -> int:
    """Runs ``fn()`` once and returns the FLOPs of the matmuls and
    convolutions it dispatched (see the module docstring)."""
    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn()
    return counter.get_total_flops()


SPAN_PREFIX = "vits."

_switch = False
_NO_SPAN = contextlib.nullcontext()
_lock = threading.Lock()
_spans: dict[str, list] = defaultdict(lambda: [0, 0.0])  # full name -> [calls, host seconds]
_counters: dict[str, int] = defaultdict(int)


def set_tracing(on: bool) -> bool:
    """Turns the switch on or off; returns its previous state."""
    global _switch
    was, _switch = _switch, bool(on)
    return was


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name

    def __enter__(self):
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.mark.__exit__(*exc)
        with _lock:
            agg = _spans[self.name]
            agg[0] += 1
            agg[1] += dt


def span(name: str):
    """A context for the phase ``name`` (recorded as ``vits.<name>``); the
    shared no-op context while tracing is off."""
    if not _switch:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while the switch is on or a
    profiler records."""
    if _switch or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counters[name] += int(n)


def snapshot() -> dict:
    """``{"spans": {"vits.<name>": {"count", "host_s"}}, "counters": {name: n}}``
    of what was recorded since import or the last ``reset``."""
    with _lock:
        return {"spans": {k: {"count": c, "host_s": s} for k, (c, s) in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clears the span aggregate and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``log_dir/trace.json`` as a Chrome trace; the switch is on inside it, so
    the port's spans are on the trace. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = set_tracing(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        set_tracing(was)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time stats (seconds)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    def restart(self) -> None:
        """The next interval starts now: time spent between steps
        (evaluation, checkpoints) stays out of the step times."""
        self._last = time.perf_counter()

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m and m == m and m > 0 else float("nan")
