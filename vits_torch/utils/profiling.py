"""Profiling / tracing hooks (port of ``vits_tpu/utils/profiling.py``): a
``torch.profiler`` trace of host and device activity exported as a Chrome
trace (Perfetto, chrome://tracing), and a lightweight step timer whose
summaries land in the training log and TensorBoard."""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
