"""The per-layer metrics read from the program's own counters
(``perfbench/program.py``): a traced line carries them where the program
recorded, and leaves them out, without raising, where it did not or cannot
(a program without the aggregate); the port's ``vits.*`` spans in a trace
leave ``tracing.reduce_trace``'s numbers as they were."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, tracing
from perfbench.tests.tiny import tiny_run

PROGRAM_METRICS = {
    "cje.serve_long": {"engine.escalations.long", "engine.pad_share.long"},
}
TRAIN_CELLS = ("cje.train", "cje_long.train")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port_tracing():
    """The port's spans and counters on for the block (a profiler turns the
    counters on in a traced run's profiled stretch; the CPU run profiles
    none)."""
    from vits_torch.utils import profiling

    profiling.reset()
    was = profiling.set_tracing(True)
    yield
    profiling.set_tracing(was)
    profiling.reset()


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_traced_line_carries_the_program_metrics(cell, tmp_path, port_tracing):
    line = harness.execute(tiny_run(cell, tmp_path, trace=True))
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items() if k in PROGRAM_METRICS[cell]}
    assert set(got) == PROGRAM_METRICS[cell]
    assert got["engine.escalations.long"] >= 0
    assert 0 <= got["engine.pad_share.long"] < 100


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_cells_run_correct_with_the_port_spans_on(cell, tmp_path, port_tracing):
    """The train step's spans live through a traced train run: the line is
    correct, the step's phases were recorded, and no program metric reads
    them (none is listed for a train cell)."""
    from vits_torch.utils import profiling

    line = harness.execute(tiny_run(cell, tmp_path, trace=True))
    assert line["correct"], line["checks"]
    assert profiling.snapshot()["spans"]["vits.train.g_update"]["count"] >= 1
    assert not set(line["metrics"]) & set().union(*PROGRAM_METRICS.values())


def test_readers_read_the_counters(monkeypatch):
    from vits_torch.utils import profiling

    counters = {"serve.requests": 4, "serve.escalations": 2, "serve.infer_calls": 7,
                "serve.frames_decoded": 800, "serve.frames_kept": 600}
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": counters})
    got = {name: _reader(name).read({}) for name in PROGRAM_METRICS["cje.serve_long"]}
    assert got == {"engine.escalations.long": 0.5, "engine.pad_share.long": 25.0}


@pytest.mark.parametrize("cell", ["cje.train", "cje.serve_long"])
def test_untraced_program_gives_no_program_metric(cell, tmp_path):
    from vits_torch.utils import profiling

    profiling.reset()
    line = harness.execute(tiny_run(cell, tmp_path, trace=True))
    assert not set(line["metrics"]) & set().union(*PROGRAM_METRICS.values())


def test_readers_read_nothing_from_a_program_without_the_aggregate(monkeypatch):
    from vits_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    for names in PROGRAM_METRICS.values():
        for name in names:
            assert _reader(name).read({}) is None


def _reader(name: str):
    return harness.load_module(harness.ROOT / "perfbench" / "metrics" / f"{name}.py",
                               "perfbench_metric_test_" + name.replace(".", "_"))


def _x(name, ts, dur, tid=1, cat="user_annotation", **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


BENCH_EVENTS = [
    _x(tracing.WINDOW, 0, 1000),
    _x("perfbench.mas", 140, 80),
    _x("aten::mm", 110, 20, cat="cpu_op"),
    _x("Optimizer.step#AdamW.step", 760, 100),
    _x("cudaLaunchKernel", 120, 5, cat="cuda_runtime", correlation=1),
    _x("cudaLaunchKernel", 160, 5, cat="cuda_runtime", correlation=2),
    _x("cudaLaunchKernel", 450, 5, tid=2, cat="cuda_runtime", correlation=3),
    _x("cudaLaunchKernel", 800, 5, cat="cuda_runtime", correlation=4),
    _x("k1", 130, 50, tid=7, cat="kernel", correlation=1),
    _x("k2", 170, 90, tid=7, cat="kernel", correlation=2),
    _x("k3", 460, 140, tid=7, cat="kernel", correlation=3),
    _x("k4", 820, 30, tid=7, cat="gpu_memcpy", correlation=4),
]
PORT_SPANS = [
    _x("vits.train.g_forward", 100, 200),
    _x("vits.mas", 150, 50),
    _x("vits.train.d_backward", 400, 300),
    _x("vits.train.g_update", 750, 150),
]


def test_port_spans_leave_reduce_trace_as_it_was():
    before = tracing.reduce_trace(BENCH_EVENTS)
    after = tracing.reduce_trace(BENCH_EVENTS + PORT_SPANS)
    assert before["spans"] == {"mas": {"count": 1, "device_s": pytest.approx(90e-6)}}
    for key in ("window_s", "busy_s", "spans", "device_ops"):
        assert after[key] == before[key], key
    assert [s for _, s in after["idle_gaps"]] == [s for _, s in before["idle_gaps"]]
    assert any(label.startswith("vits.") for label, _ in after["idle_gaps"])
