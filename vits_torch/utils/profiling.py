"""Profiling / tracing hooks (port of ``vits_tpu/utils/profiling.py``): a
``torch.profiler`` trace of host and device activity exported as a Chrome
trace (Perfetto, chrome://tracing), a lightweight step timer whose
summaries land in the training log and TensorBoard, and what the benchmark
scripts (``bench*_torch.py``) need to state a model FLOP utilisation: the
card's name and power limit, its dense bf16 peak, and a step's FLOPs.

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
import time

import torch
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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``log_dir/trace.json`` as a Chrome trace. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
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
