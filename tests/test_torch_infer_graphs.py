"""The serving engine's CUDA graphs of ``SynthesizerTrn.infer``
(``vits_torch/serve/graphs.py``) against the eager call, and the reader of
``engine.graph_hit_share.long``.

On the card, at the full CJE configuration (``configs/config_cje.yaml``,
PyTorch's init under a fixed seed, ``max_frames`` 1000): a replay gives the
eager call's ``wav`` and ``y_lengths`` bit for bit at every batch-1 key
(4 text buckets x 3 frame buckets, among them every key a long paragraph's
pieces reach), for a 4-row ``synthesize_batch`` and for paragraphs whose
pieces go out as calls of 8, 4, 2 and 1 rows; captures count the
distinct keys and replays the calls after them; weights loaded in place
after a capture are seen by the next replay; two threads synthesizing at
once each get their eager audio. The card tests run where there is no JAX:
``python -m pytest --noconftest tests/test_torch_infer_graphs.py -m cuda``.
"""

from __future__ import annotations

import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from vits_torch.serve.engine import TTSEngine
from vits_torch.serve.graphs import InferGraphs
from vits_torch.text.symbols import symbols
from vits_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "config_cje.yaml"
SENTENCE = "The quick brown fox jumps over the lazy dog, and the dog sleeps on."
PARAGRAPH = "[EN]" + " ".join([SENTENCE] * 9) + "[EN]"
# 11 and 4 pieces at (384 ids, 1000 frames): calls of 8 + 2 + 1 and of 4 rows
BATCHED = ["[EN]" + " ".join([SENTENCE] * k) + "[EN]" for k in (27, 10)]
SHORT = ["[EN]Hello world.[EN]", "[EN]Good morning.[EN]", "[EN]See you soon.[EN]",
         "[EN]Thank you.[EN]"]


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        eng = TTSEngine(str(CONFIG), max_frames=1000)
    yield eng
    eng.model.infer_graphs = None
    torch.cuda.synchronize()


@pytest.fixture
def graphs(engine):
    """A fresh cache, and the port's counters on, for the test."""
    engine.model.infer_graphs = InferGraphs()
    profiling.reset()
    was = profiling.set_tracing(True)
    yield engine.model.infer_graphs
    profiling.set_tracing(was)
    profiling.reset()


def _call(engine, tx, frames, seed):
    """The arguments of one batch-1 call at (tx, frames): tx - 3 ids, the
    duration and scope shift as [1] tensors, as the engine's budgeted calls
    give them."""
    g = torch.Generator().manual_seed(seed)
    n = tx - 3
    x = torch.zeros(1, tx, dtype=torch.int64)
    x[:, :n] = torch.randint(1, len(symbols), (1, n), generator=g)
    t = torch.zeros(1, tx, dtype=torch.int64)
    t[:, :n] = torch.randint(0, 3, (1, n), generator=g)
    dev = engine.device
    noise = engine._noise([seed], engine._synth_shapes(tx, frames))
    args = (x.to(dev), t.to(dev), torch.tensor([n], device=dev),
            torch.tensor([seed % 5], device=dev))
    controls = (torch.tensor([(0.8, 1.0, 1.3)[seed % 3]], device=dev),
                torch.tensor([(-15, 0, 15)[seed % 3]], device=dev))
    return args, dict(noise=noise, **engine._infer_kwargs(*controls, frames))


def _eager(engine, args, kwargs):
    return engine.model._infer(*args, **kwargs)


def _same(got, want):
    wav, _, y_len = got
    wav_e, _, y_len_e = want
    assert torch.equal(y_len, y_len_e)
    assert torch.equal(wav, wav_e), (wav - wav_e).abs().max().item()


@pytest.mark.cuda
def test_replay_equals_eager_at_every_batch1_key(engine, graphs):
    keys = [(tx, f) for tx in engine.TEXT_BUCKETS for f in engine._frame_buckets()]
    assert len(keys) == 12
    with torch.inference_mode():
        for i, (tx, frames) in enumerate(keys):
            for seed in (10 * i, 10 * i + 1):  # the capture's call, then a replay
                args, kwargs = _call(engine, tx, frames, seed)
                _same(engine.model.infer(*args, **kwargs), _eager(engine, args, kwargs))
    counters = profiling.snapshot()["counters"]
    assert counters["serve.graph_captures"] == len(keys)
    assert counters["serve.graph_replays"] == len(keys)


@pytest.mark.cuda
def test_batch_of_four_rows_equals_eager(engine, graphs):
    reqs = [{"text": text, "seed": 10 + i, "speaker_id": i, "duration": 0.9 + 0.1 * i,
             "scope_shift": (-15, 0, 15, 5)[i]} for i, text in enumerate(SHORT)]
    with torch.inference_mode():
        ns = [len(engine.get_phoneme(r["text"])[0]) for r in reqs]
    keys = {(engine._bucket(n), engine._first_frames(n, r["duration"])) for n, r in zip(ns, reqs)}
    assert len(keys) == 1, keys  # one group: one 4-row call
    first, again = engine.synthesize_batch(reqs), engine.synthesize_batch(reqs)
    engine.model.infer_graphs = None
    eager = engine.synthesize_batch(reqs)
    for a, b, e in zip(first, again, eager):
        np.testing.assert_array_equal(a, e)
        np.testing.assert_array_equal(b, e)
    counters = profiling.snapshot()["counters"]
    assert counters["serve.graph_captures"] >= 1 and counters["serve.graph_replays"] >= 1
    # three rounds of the same calls; every call of the two graphed ones took the cache
    graphed = counters["serve.graph_captures"] + counters["serve.graph_replays"]
    assert 3 * graphed == 2 * counters["serve.infer_calls"]


@pytest.mark.cuda
def test_paragraph_replays_equal_its_eager_batched_calls(engine, graphs):
    """A paragraph's pieces go out as batched calls, all queued before one
    host sync: replayed, its audio is that of the same calls run eagerly, bit
    for bit; the keys of 8, 4, 2 and 1 rows at (384, 1000) are captured once
    and replayed after."""
    keys = []
    original = engine.model.infer

    def infer(x, *args, **kwargs):
        keys.append((*x.shape, kwargs["max_frames"]))
        return original(x, *args, **kwargs)

    engine.model.infer = infer
    try:
        graphed = [[engine.synthesize(text, 2, seed=21 + i)[1][1] for i, text in enumerate(BATCHED)]
                   for _ in range(2)]
        replayed = list(keys)
        engine.model.infer_graphs = None
        eager = [engine.synthesize(text, 2, seed=21 + i)[1][1] for i, text in enumerate(BATCHED)]
    finally:
        del engine.model.infer
    assert {(rows, 384, 1000) for rows in (8, 4, 2, 1)} <= set(replayed)
    assert len(replayed) == 2 * len(keys[len(replayed):]) == 8  # (8 + 2 + 1) + (4), twice
    for got in graphed:
        for a, e in zip(got, eager):
            np.testing.assert_array_equal(a, e)
    counters = profiling.snapshot()["counters"]
    assert counters["serve.graph_captures"] == len(set(replayed))
    assert counters["serve.graph_replays"] == len(replayed) - len(set(replayed))
    assert counters["serve.rows"] == 3 * (11 + 4)


@pytest.mark.cuda
def test_counts_a_capture_a_key_and_a_replay_a_later_call(engine, graphs):
    keys = []
    original = engine.model.infer

    def infer(x, *args, **kwargs):
        keys.append((tuple(x.shape), kwargs["max_frames"]))
        return original(x, *args, **kwargs)

    engine.model.infer = infer
    try:
        for seed in (1, 2, 3):
            engine.synthesize(PARAGRAPH, 1, seed=seed)
    finally:
        del engine.model.infer
    counters = profiling.snapshot()["counters"]
    assert len(keys) == counters["serve.infer_calls"] >= 6
    assert counters["serve.graph_captures"] == len(set(keys)) >= 1
    assert counters.get("serve.graph_replays", 0) == len(keys) - len(set(keys))


@pytest.mark.cuda
def test_weights_loaded_in_place_after_capture_are_replayed(engine, graphs):
    model = engine.model
    with torch.inference_mode():
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        args, kwargs = _call(engine, 128, 512, seed=5)
        before = model.infer(*args, **kwargs)
        g = torch.Generator(device=engine.device).manual_seed(7)
        moved = {k: v + 0.02 * v.abs().mean() * torch.randn(v.shape, generator=g, device=v.device)
                 if v.is_floating_point() else v for k, v in saved.items()}
        try:
            model.load_state_dict(moved)
            after = model.infer(*args, **kwargs)
            _same(after, _eager(engine, args, kwargs))
            assert not torch.equal(after[0], before[0])
        finally:
            model.load_state_dict(saved)
        _same(model.infer(*args, **kwargs), before)
    assert profiling.snapshot()["counters"]["serve.graph_captures"] == 1


@pytest.mark.cuda
def test_two_threads_get_their_eager_audio(engine, graphs):
    jobs = [(PARAGRAPH, 0, 11), (SHORT[0] + SHORT[1], 3, 12), (SHORT[2], 2, 13), (PARAGRAPH, 4, 14)]
    engine.model.infer_graphs = None
    eager = [engine.synthesize(text, spk, seed=seed)[1][1] for text, spk, seed in jobs]
    engine.model.infer_graphs = graphs
    got = {}
    start = threading.Barrier(2)

    def serve(mine):
        start.wait()
        for _ in range(3):
            for j in mine:
                text, spk, seed = jobs[j]
                got.setdefault(j, []).append(engine.synthesize(text, spk, seed=seed)[1][1])

    threads = [threading.Thread(target=serve, args=(mine,)) for mine in ((0, 1), (2, 3))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        assert not th.is_alive()
    for j, want in enumerate(eager):
        assert len(got[j]) == 3
        for audio in got[j]:
            np.testing.assert_array_equal(audio, want)
    assert profiling.snapshot()["counters"]["serve.graph_replays"] > 0


@pytest.mark.parametrize("case,want", [
    ("replayable", True), ("cpu", False), ("generator", False), ("no_noise", False),
    ("one_draw", False), ("number_controls", False), ("grad_mode", False),
])
def test_takes_only_calls_a_graph_can_replay(case, want):
    """The cache takes a call on a CUDA device with both draws given, the
    duration and shift as tensors, under inference mode; every other call
    runs eagerly (``x`` stands in for a CUDA tensor: only its device is
    read)."""
    x = types.SimpleNamespace(is_cuda=case != "cpu")
    noise = {"sdp_noise": torch.zeros(1), "eps": torch.zeros(1)}
    if case == "no_noise":
        noise = None
    elif case == "one_draw":
        noise.pop("eps")
    gen = torch.Generator() if case == "generator" else None
    controls = (1.0, 0) if case == "number_controls" else (torch.ones(1), torch.zeros(1))
    with torch.inference_mode(case != "grad_mode"):
        assert InferGraphs.takes(x, noise, gen, *controls) is want


def _reader():
    import importlib.util

    path = ROOT / "perfbench" / "metrics" / "engine.graph_hit_share.long.py"
    spec = importlib.util.spec_from_file_location("graph_hit_share_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({"serve.infer_calls": 8, "serve.graph_replays": 6, "serve.graph_captures": 2}, 75.0),
    ({"serve.infer_calls": 5, "serve.graph_replays": 5}, 100.0),
    ({"serve.infer_calls": 3, "serve.graph_captures": 3}, 0.0),
    ({"serve.infer_calls": 5, "serve.frames_decoded": 5000}, None),  # no graphs counted
    ({}, None),
])
def test_hit_share_reads_the_counters(counters, want, monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": counters})
    assert _reader().read({}) == want


def test_hit_share_reads_nothing_without_the_aggregate(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    assert _reader().read({}) is None
