"""The port's spans and counters (``vits_torch/utils/profiling.py``) on the
CPU: off they record nothing and call neither the profiler nor the clock; on
they nest, aggregate and reset; ``trace()`` turns them on, another profile
the counters only; the train step opens each phase once; the engine counts
its requests, budgeted calls, escalations and frames; ``tools/profile_torch_slice.py::reduce_spans`` puts
device and idle time down to the innermost span of a fixed synthetic trace."""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vits_torch.utils import profiling
from vits_torch.utils.profiling import count, span

from tests.test_torch_serve import CFG

ROOT = Path(__file__).resolve().parents[1]
TRAIN_PHASES = ("inputs", "g_forward", "d_forward", "d_backward", "d_update", "g_loss",
                "g_backward", "g_update")


@pytest.fixture(autouse=True)
def clean():
    was = profiling.set_tracing(False)
    profiling.reset()
    yield
    profiling.set_tracing(was)
    profiling.reset()


def _trace_events(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_off_records_nothing_and_calls_neither_profiler_nor_clock(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(profiling.torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter", refuse)
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            count("c", 5)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_on_nests_aggregates_and_resets(tmp_path):
    profiling.set_tracing(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span("outer"):
                with span("inner"):
                    time.sleep(0.01)
                count("c", 3)
    count("c")
    snap = profiling.snapshot()
    assert snap["counters"] == {"c": 7}
    outer, inner = snap["spans"]["vits.outer"], snap["spans"]["vits.inner"]
    assert outer["count"] == inner["count"] == 2
    assert outer["host_s"] >= inner["host_s"] >= 0.02
    marks = {e["name"]: e for e in _trace_events(prof, tmp_path)
             if e.get("cat") == "user_annotation" and e["name"].startswith("vits.")}
    o, i = marks["vits.outer"], marks["vits.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_a_profiler_turns_spans_on(tmp_path):
    """``trace()`` (the train CLI's ``profile_step``) turns the switch on for
    its block: its trace carries the spans and the aggregate fills. Another
    profile, as the benchmark's traced stretch, turns on the counters only:
    no ``vits.*`` mark enters a profile that did not ask for it."""
    with profiling.trace(str(tmp_path)):
        with span("phase"):
            count("c")
    with span("after"):
        count("c")
    assert set(profiling.snapshot()["spans"]) == {"vits.phase"}
    assert profiling.snapshot()["spans"]["vits.phase"]["count"] == 1
    assert profiling.snapshot()["counters"] == {"c": 1}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "vits.phase" for e in events)
    assert profiling.set_tracing(False) is False  # put back after the block

    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("phase"):
            count("c", 2)
    assert profiling.snapshot() == {"spans": {}, "counters": {"c": 2}}
    assert not any(e["name"].startswith("vits.") for e in _trace_events(prof, tmp_path))


def test_counts_from_many_threads_add_up():
    profiling.set_tracing(True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                count("c")
                with span("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.snapshot()
    assert snap["counters"]["c"] == 32000 and snap["spans"]["vits.s"]["count"] == 32000


def _tiny_state():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.models import avocodo
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.training.step import create_train_state

    hps = tiny_hps()
    batch, noise = cs.policy_batch(cs.TINY_TRAIN["inter_channels"], cs.TINY_TRAIN["yin_channels"],
                                   2, 9, [16, 16], 0, n_speakers=3)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = SynthesizerTrn(**cs.TINY_TRAIN, device="cpu")
        disc = avocodo.probe_discriminator(segment_size=2048, device="cpu")
    return create_train_state(model, disc, hps, steps_per_epoch=10), batch, noise, hps


def test_train_step_opens_each_phase_once():
    from vits_torch.training.step import train_step

    state, batch, noise, hps = _tiny_state()
    train_step(state, batch, hps, noise=noise)  # tracing off: nothing recorded
    assert profiling.snapshot()["spans"] == {}
    profiling.set_tracing(True)
    t0 = time.perf_counter()
    train_step(state, batch, hps, noise=noise)
    wall = time.perf_counter() - t0
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {f"vits.train.{p}" for p in TRAIN_PHASES} | {"vits.mas"}
    assert all(s["count"] == 1 for s in spans.values())
    phases = sum(spans[f"vits.train.{p}"]["host_s"] for p in TRAIN_PHASES)
    assert 0 < phases <= wall
    assert spans["vits.mas"]["host_s"] <= spans["vits.train.g_forward"]["host_s"]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A tiny engine whose durations run long (the duration flow's last
    affine shifted, as ``test_torch_serve.py`` does to the JAX weights), with
    small frame buckets: the first budget saturates and escalates."""
    from vits_torch.serve.engine import TTSEngine

    path = tmp_path_factory.mktemp("spans") / "config.yaml"
    path.write_text(yaml.safe_dump(CFG))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        eng = TTSEngine(str(path), max_frames=96, device="cpu")
    with torch.no_grad():
        eng.model.duration_predictor.flows[0].m -= torch.tensor([[2.0], [0.0]])
    eng.FRAME_BUCKETS = (32, 64)
    return eng


SHORT = "[P]ni3#hao3[P]"
LONG = "[P]" + " ".join(["ni3#hao3%"] * 45) + "[P]"


@pytest.mark.parametrize("path", ["synthesize", "synthesize_chunked"])
def test_engine_counts_escalations_and_frames(engine, path):
    profiling.set_tracing(True)
    texts = [SHORT, LONG]
    pieces = frames = 0
    for i, text in enumerate(texts):
        seq, lang, _ = engine.get_phoneme(text)
        pieces += len(engine._split_segments(seq, lang, engine.TEXT_BUCKETS[-1]))
        _, (_, audio) = getattr(engine, path)(text, 0, seed=i, duration=0.25)
        frames += len(audio) // engine.hop
    assert pieces > len(texts)
    snap = profiling.snapshot()
    c, spans = snap["counters"], snap["spans"]
    assert c["serve.requests"] == len(texts)
    assert c["serve.escalations"] >= 1
    assert c["serve.escalations"] == c["serve.infer_calls"] - pieces
    assert c["serve.frames_kept"] == frames  # the frames returned, and no others
    assert 0 < c["serve.frames_kept"] <= c["serve.frames_decoded"]
    assert spans["vits.serve.g2p"]["count"] == 2 * len(texts)  # here and in the engine
    assert spans["vits.serve.noise"]["count"] == spans["vits.serve.sync"]["count"] \
        == c["serve.infer_calls"]
    if path == "synthesize":
        assert spans["vits.serve.infer"]["count"] == c["serve.infer_calls"]
        assert spans["vits.serve.d2h"]["count"] == pieces


def test_batch_counts_padded_rows(engine):
    profiling.set_tracing(True)
    reqs = [{"text": "[P]a1[P]", "seed": 1}, {"text": "[P]a1#b2[P]", "seed": 2},
            {"text": "[P]a1#b2#c3[P]", "seed": 3}]
    out = engine.synthesize_batch(reqs)
    assert all(isinstance(o, np.ndarray) for o in out)
    c = profiling.snapshot()["counters"]
    assert c["serve.requests"] == len(reqs)  # a saturated row's redo is no new request
    # one group of 3 rows padded to 4 at the first budget, 32 frames
    assert c["serve.infer_calls"] >= 1 and c["serve.frames_decoded"] >= 4 * 32
    # a saturated row is kept only from the call whose audio it returns
    assert c["serve.frames_kept"] == sum(len(o) // engine.hop for o in out)
    assert 0 < c["serve.frames_kept"] < c["serve.frames_decoded"]


def test_escalation_counts_the_discarded_call_as_padding(engine, monkeypatch):
    """An escalated call's frames are all padding: the request's pad share is
    above that of the call whose audio it returns."""
    budgets = []
    infer = engine.model.infer

    def spy(*args, **kwargs):
        budgets.append(kwargs["max_frames"])
        return infer(*args, **kwargs)

    monkeypatch.setattr(engine.model, "infer", spy)
    profiling.set_tracing(True)
    _, (_, audio) = engine.synthesize(SHORT, 0, seed=0, duration=0.25)
    c = profiling.snapshot()["counters"]
    kept = len(audio) // engine.hop
    assert c["serve.escalations"] >= 1 and len(budgets) == c["serve.infer_calls"] >= 2
    assert c["serve.frames_decoded"] == sum(budgets)
    assert c["serve.frames_kept"] == kept
    pad_share = 1 - c["serve.frames_kept"] / c["serve.frames_decoded"]
    assert pad_share > 1 - kept / budgets[-1]


def _x(name, ts, dur, tid=1, cat="user_annotation", **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


# A stretch of 1000 us: the generator forward (MAS nested in it), D's
# backward with a launch from autograd's thread (tid 2), G's update with
# torch's own optimizer annotation inside, and a launch outside any span.
SYNTHETIC = [
    _x("window", 0, 1000),
    _x("vits.train.g_forward", 100, 200),
    _x("vits.mas", 150, 50),
    _x("vits.train.d_backward", 400, 300),
    _x("vits.train.g_update", 750, 150),
    _x("Optimizer.step#AdamW.step", 760, 100),
    _x("aten::mm", 110, 20, cat="cpu_op"),
    _x("cudaLaunchKernel", 120, 5, cat="cuda_runtime", correlation=1),
    _x("cudaLaunchKernel", 160, 5, cat="cuda_runtime", correlation=2),
    _x("cudaLaunchKernel", 450, 5, tid=2, cat="cuda_runtime", correlation=3),
    _x("cudaLaunchKernel", 800, 5, cat="cuda_runtime", correlation=4),
    _x("cudaLaunchKernel", 950, 5, cat="cuda_runtime", correlation=5),
    _x("k1", 130, 50, tid=7, cat="kernel", correlation=1),
    _x("k2", 170, 90, tid=7, cat="kernel", correlation=2),
    _x("k3", 460, 140, tid=7, cat="kernel", correlation=3),
    _x("k4", 820, 30, tid=7, cat="gpu_memcpy", correlation=4),
    _x("k5", 960, 50, tid=7, cat="kernel", correlation=5),
]


def test_reduce_spans_on_a_synthetic_trace():
    sys.path.insert(0, str(ROOT / "tools"))
    from profile_torch_slice import reduce_spans

    r = reduce_spans(SYNTHETIC, "window")
    us = 1e-6
    assert r["window_s"] == pytest.approx(1000 * us)
    assert r["busy_s"] == pytest.approx(340 * us)  # 130-260, 460-600, 820-850, 960-1000
    want = {  # count, host, device, idle (us)
        "vits.train.g_forward": (1, 200, 50, 70),
        "vits.mas": (1, 50, 90, 0),
        "vits.train.d_backward": (1, 300, 140, 160),  # k3 from autograd's thread
        "vits.train.g_update": (1, 150, 30, 120),
    }
    assert set(r["spans"]) == set(want)
    for name, (n, host, dev, idle) in want.items():
        got = r["spans"][name]
        assert got["count"] == n
        assert got["host_s"] == pytest.approx(host * us)
        assert got["device_s"] == pytest.approx(dev * us)
        assert got["idle_s"] == pytest.approx(idle * us, abs=1e-12)
    assert r["idle_outside_s"] == pytest.approx(310 * us)
    total = sum(s["idle_s"] for s in r["spans"].values()) + r["idle_outside_s"]
    assert total == pytest.approx(r["window_s"] - r["busy_s"]) == pytest.approx(r["idle_s"])
    assert reduce_spans(SYNTHETIC, "no such window") == {}
