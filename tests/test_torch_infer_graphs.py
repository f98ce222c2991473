"""The serving engine's CUDA graphs of ``SynthesizerTrn.infer``
(``vits_torch/serve/graphs.py``: a stage to the predicted lengths, one host
read, then the frame work at the fewest frames F of the ladder that hold
the call's rows) against the eager call at F, and the reader of
``engine.graph_hit_share.long``.

On the card, at the full CJE configuration (``configs/config_cje.yaml``,
PyTorch's init under a fixed seed, ``max_frames`` 1000): a replay decodes
the sized F and gives the eager call's ``wav`` and ``y_lengths`` at
``max_frames`` F bit for bit at every batch-1 budget key (4 text buckets x
3 frame budgets, among them every key a long paragraph's pieces reach), for
a 4-row ``synthesize_batch`` and for paragraphs whose pieces go out as calls
of 8, 4, 2 and 1 rows; captures count the distinct keys of each stage and
replays the calls that captured neither, so that the same calls again are
all replays; weights loaded in place after a capture are seen by the next
replay of each stage; two threads synthesizing at once each get the eager
audio at the sized budgets. The card tests run where there is no JAX:
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
from vits_torch.serve.graphs import InferGraphs, sized_frames
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


def _eager(model, args, kwargs, frames=None):
    """The eager call at ``max_frames`` ``frames`` (the call's budget if
    None), its prior noise cut to those frames."""
    if frames is not None:
        noise = dict(kwargs["noise"], eps=kwargs["noise"]["eps"][:, :frames])
        kwargs = dict(kwargs, noise=noise, max_frames=frames)
    return model._infer(*args, **kwargs)


def _sized(model, args, kwargs):
    """The eager call at the budget a graphed call sizes: the fewest frames
    of the ladder under its budget that hold its rows' predicted lengths."""
    y_len = _eager(model, args, kwargs)[2]
    return _eager(model, args, kwargs, sized_frames(int(y_len.max()), kwargs["max_frames"]))


def _eager_sized_infer(model):
    """An ``infer`` for ``model`` that runs every budgeted call eagerly at
    the budget its graphs would size (``_sized``)."""
    def infer(*args, **kwargs):
        return _sized(model, args, kwargs)
    return infer


def _same(got, want):
    wav, _, y_len = got
    wav_e, _, y_len_e = want
    assert torch.equal(y_len, y_len_e)
    assert wav.shape == wav_e.shape
    assert torch.equal(wav, wav_e), (wav - wav_e).abs().max().item()


def _frames(engine, wav) -> int:
    return wav.shape[1] // engine.hop


def _counts(calls) -> tuple[int, int]:
    """(captures, replays) of graphed calls at ``calls``' keys, in order:
    (rows, text bucket, budget, sized frames) each. A stage captures at its
    key's first call: stage 1 at (rows, text bucket, budget), stage 2 at
    (rows, frames); a call that captured neither is a replay."""
    first, second = set(), set()
    captures = replays = 0
    for rows, tx, budget, frames in calls:
        new = [(rows, tx, budget) not in first, (rows, frames) not in second]
        first.add((rows, tx, budget))
        second.add((rows, frames))
        captures += sum(new)
        replays += not any(new)
    return captures, replays


def _recorded(engine):
    """Wraps ``engine.model.infer`` (undo with ``del engine.model.infer``):
    the list it fills with each call's (rows, text bucket, budget, frames
    decoded)."""
    calls, original = [], engine.model.infer

    def infer(x, *args, **kwargs):
        out = original(x, *args, **kwargs)
        calls.append((*x.shape, kwargs["max_frames"], _frames(engine, out[0])))
        return out

    engine.model.infer = infer
    return calls


@pytest.mark.cuda
def test_replay_equals_eager_at_every_batch1_key(engine, graphs):
    keys = [(tx, f) for tx in engine.TEXT_BUCKETS for f in engine._frame_buckets()]
    assert len(keys) == 12
    calls = []
    with torch.inference_mode():
        for i, (tx, budget) in enumerate(keys):
            for seed in (10 * i, 10 * i + 1):  # the capture's call, then a replay
                args, kwargs = _call(engine, tx, budget, seed)
                got = engine.model.infer(*args, **kwargs)
                frames = _frames(engine, got[0])
                assert frames == sized_frames(int(got[2].max()), budget)
                _same(got, _eager(engine.model, args, kwargs, frames))
                calls.append((1, tx, budget, frames))
        assert any(f < budget for _, _, budget, f in calls)
        captures, replays = _counts(calls)
        counters = profiling.snapshot()["counters"]
        assert counters["serve.graph_captures"] == captures
        assert counters.get("serve.graph_replays", 0) == replays
        # the same calls again: every one a replay of both stages
        profiling.reset()
        for i, (tx, budget) in enumerate(keys):
            for seed in (10 * i, 10 * i + 1):
                args, kwargs = _call(engine, tx, budget, seed)
                engine.model.infer(*args, **kwargs)
    counters = profiling.snapshot()["counters"]
    assert counters["serve.graph_replays"] == 2 * len(keys)
    assert "serve.graph_captures" not in counters


@pytest.mark.cuda
def test_batch_of_four_rows_equals_eager(engine, graphs):
    reqs = [{"text": text, "seed": 10 + i, "speaker_id": i, "duration": 0.9 + 0.1 * i,
             "scope_shift": (-15, 0, 15, 5)[i]} for i, text in enumerate(SHORT)]
    with torch.inference_mode():
        ns = [len(engine.get_phoneme(r["text"])[0]) for r in reqs]
    keys = {(engine._bucket(n), engine._first_frames(n, r["duration"])) for n, r in zip(ns, reqs)}
    assert len(keys) == 1, keys  # one group: one 4-row call
    calls = _recorded(engine)
    try:
        first, again = engine.synthesize_batch(reqs), engine.synthesize_batch(reqs)
    finally:
        del engine.model.infer
    engine.model.infer_graphs = None
    engine.model.infer = _eager_sized_infer(engine.model)
    try:
        eager = engine.synthesize_batch(reqs)
    finally:
        del engine.model.infer
    for a, b, e in zip(first, again, eager):
        np.testing.assert_array_equal(a, e)
        np.testing.assert_array_equal(b, e)
    assert len(calls) == 2 and calls[0] == calls[1] and calls[0][0] == 4
    counters = profiling.snapshot()["counters"]
    # the first call captured both stages, the second replayed both
    assert counters["serve.graph_captures"] == 2 and counters["serve.graph_replays"] == 1
    assert counters["serve.infer_calls"] == 3


@pytest.mark.cuda
def test_paragraph_replays_equal_its_eager_batched_calls(engine, graphs):
    """A paragraph's pieces go out as batched calls, all queued before one
    host sync: replayed, its audio is that of the same calls run eagerly at
    the budgets they sized, bit for bit; the keys of 8, 4, 2 and 1 rows at
    (384, 1000) are captured once a stage and replayed after."""
    keys = _recorded(engine)
    try:
        graphed = [[engine.synthesize(text, 2, seed=21 + i)[1][1] for i, text in enumerate(BATCHED)]
                   for _ in range(2)]
    finally:
        del engine.model.infer
    engine.model.infer_graphs = None
    engine.model.infer = _eager_sized_infer(engine.model)
    try:
        eager = [engine.synthesize(text, 2, seed=21 + i)[1][1] for i, text in enumerate(BATCHED)]
    finally:
        del engine.model.infer
    assert {(rows, 384, 1000) for rows in (8, 4, 2, 1)} <= {k[:3] for k in keys}
    assert len(keys) == 8 and keys[:4] == keys[4:]  # (8 + 2 + 1) + (4), twice
    assert any(k[3] < k[2] for k in keys)
    for got in graphed:
        for a, e in zip(got, eager):
            np.testing.assert_array_equal(a, e)
    captures, replays = _counts(keys)
    counters = profiling.snapshot()["counters"]
    assert counters["serve.graph_captures"] == captures
    assert counters["serve.graph_replays"] == replays >= 4
    assert counters["serve.rows"] == 3 * (11 + 4)


@pytest.mark.cuda
def test_counts_a_capture_a_key_and_a_replay_a_later_call(engine, graphs):
    keys = _recorded(engine)
    try:
        for seed in (1, 2, 3):
            engine.synthesize(PARAGRAPH, 1, seed=seed)
    finally:
        del engine.model.infer
    captures, replays = _counts(keys)
    counters = profiling.snapshot()["counters"]
    assert len(keys) == counters["serve.infer_calls"] >= 6
    assert counters["serve.graph_captures"] == captures >= 2
    assert counters.get("serve.graph_replays", 0) == replays
    assert counters["serve.frames_decoded"] == sum(r * f for r, _, _, f in keys)
    assert counters.get("serve.sized_calls", 0) == sum(f < m for _, _, m, f in keys)


@pytest.mark.cuda
def test_weights_loaded_in_place_after_capture_are_replayed(engine, graphs):
    """Weights moved in place after the capture: first those of the frame
    stage alone (the flow and the decoder; the lengths, and so the sized
    frames, stay), then the others; each time the next call replays both
    stages and gives the eager call with the moved weights."""
    model = engine.model
    with torch.inference_mode():
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        args, kwargs = _call(engine, 128, 512, seed=5)
        before = model.infer(*args, **kwargs)
        g = torch.Generator(device=engine.device).manual_seed(7)
        moved = {k: v + 0.02 * v.abs().mean() * torch.randn(v.shape, generator=g, device=v.device)
                 if v.is_floating_point() else v for k, v in saved.items()}
        frame_stage = ("flow.", "waveform_decoder.")
        try:
            model.load_state_dict({k: moved[k] if k.startswith(frame_stage) else v
                                   for k, v in saved.items()})
            after = model.infer(*args, **kwargs)
            _same(after, _sized(model, args, kwargs))
            assert torch.equal(after[2], before[2]) and not torch.equal(after[0], before[0])
            replays = profiling.snapshot()["counters"]["serve.graph_replays"]
            assert replays == 1
            model.load_state_dict(moved)
            again = model.infer(*args, **kwargs)
            _same(again, _sized(model, args, kwargs))
        finally:
            model.load_state_dict(saved)
        _same(model.infer(*args, **kwargs), before)
    # before's call captured both stages; a moved length may have sized a new stage 2
    counters = profiling.snapshot()["counters"]
    assert 2 <= counters["serve.graph_captures"] <= 3
    assert counters["serve.graph_replays"] == 5 - counters["serve.graph_captures"]


@pytest.mark.cuda
def test_two_threads_get_their_eager_audio(engine, graphs):
    jobs = [(PARAGRAPH, 0, 11), (SHORT[0] + SHORT[1], 3, 12), (SHORT[2], 2, 13), (PARAGRAPH, 4, 14)]
    engine.model.infer_graphs = None
    engine.model.infer = _eager_sized_infer(engine.model)
    try:
        eager = [engine.synthesize(text, spk, seed=seed)[1][1] for text, spk, seed in jobs]
    finally:
        del engine.model.infer
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
