"""What the program records of itself: the port's counters
(``vits_torch/utils/profiling.py``), live while a profiler records, as in
the profiled stretch of a traced run (its spans only under its own switch).

``snapshot()`` is the port's in-process aggregate, ``{"spans": {"vits.<name>":
{"count", "host_s"}}, "counters": {name: n}}``, or ``{}`` where the program
keeps none (a program older than its spans)."""

from __future__ import annotations


def snapshot() -> dict:
    from vits_torch.utils import profiling

    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else {}
