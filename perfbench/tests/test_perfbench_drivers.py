"""Each driver end to end on the CPU at a tiny size: the result line's keys,
``correct`` true, and ``correct`` false under each fault the cell can have
(a step that leaves the state unchanged, or the discriminator's; half the
batch, the mean over the rest; a path or an answer altered where it is
produced)."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = ["cje.train", "cje_long.train", "cje.serve", "cje.serve_long"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cell, trace, tmp_path):
    run = tiny_run(cell, tmp_path, trace=bool(trace))
    line = harness.execute(run)
    json.dumps(line)
    assert set(line) - {"breakdown"} == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    bench = json.loads((run.root / "BENCHMARK.json").read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())


def _unchanged(real, which=("model", "disc")):
    def step(state, batch, hps, **kw):
        params = lambda: [p for w in which for p in getattr(state, w).parameters()]  # noqa: E731
        before = [p.detach().clone() for p in params()]
        out = real(state, batch, hps, **kw)
        with torch.no_grad():
            for p, b in zip(params(), before):
                p.copy_(b)
        return out
    return step


def _d_unchanged(real):
    return _unchanged(real, ("disc",))


def _half_batch(real):
    def step(state, batch, hps, noise=None, **kw):
        n = batch["x"].shape[0] // 2
        half = {k: v[:n] for k, v in batch.items()}
        nz = {k: (torch.cat([v[:n], v[2 * n: 3 * n]]) if k.startswith("phi") else v[:n])
              for k, v in noise.items()}
        return real(state, half, hps, noise=nz, **kw)
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_train_fault_is_not_correct(fault, tmp_path, monkeypatch):
    import vits_torch.training.step as step_mod

    monkeypatch.setattr(step_mod, "train_step", fault(step_mod.train_step))
    line = harness.execute(tiny_run("cje.train", tmp_path))
    assert not line["correct"], line["checks"]


def test_d_unchanged_reads_one(tmp_path, monkeypatch):
    import vits_torch.training.step as step_mod

    monkeypatch.setattr(step_mod, "train_step", _d_unchanged(step_mod.train_step))
    line = harness.execute(tiny_run("cje.train", tmp_path))
    assert not line["correct"], line["checks"]
    assert line["checks"]["delta_gap.d"]["value"] == pytest.approx(1.0)
    assert line["checks"]["delta_gap"]["value"] < 0.5


def test_seeded_dropout_only_in_checked_steps(tmp_path, monkeypatch):
    import vits_torch.training.step as step_mod
    from perfbench.randomness import SeededDropout

    real = step_mod.train_step
    seen = []

    def step(state, batch, hps, **kw):
        kinds = {type(m) for m in state.model.modules()}
        seen.append((SeededDropout in kinds, torch.nn.Dropout in kinds))
        return real(state, batch, hps, **kw)

    monkeypatch.setattr(step_mod, "train_step", step)
    run = tiny_run("cje.train", tmp_path)
    line = harness.execute(run)
    assert line["correct"], line["checks"]
    n = int(run.traffic.check_steps)
    assert seen[:n] == [(True, False)] * n
    assert len(seen) > n and all(k == (False, True) for k in seen[n:])


def test_altered_path_is_not_correct(tmp_path, monkeypatch):
    import vits_torch.models.synthesizer as synthesizer

    real = synthesizer.maximum_path

    def maximum_path(neg, mask):
        path = real(neg, mask).clone()
        path[0, 0, 1] = 1.0  # item 0's first frame also on its second token
        return path

    monkeypatch.setattr(synthesizer, "maximum_path", maximum_path)
    line = harness.execute(tiny_run("cje.train", tmp_path))
    assert not line["correct"], line["checks"]
    assert line["checks"]["mas_path_off"]["value"] > 0


@pytest.mark.parametrize("cell", ["cje.serve", "cje.serve_long"])
def test_altered_answer_is_not_correct(cell, tmp_path, monkeypatch):
    from vits_torch.models.synthesizer import SynthesizerTrn

    real = SynthesizerTrn.infer

    def infer(self, *a, **kw):
        wav, mask, lengths = real(self, *a, **kw)
        return wav * 1.01, mask, lengths

    monkeypatch.setattr(SynthesizerTrn, "infer", infer)
    line = harness.execute(tiny_run(cell, tmp_path))
    assert not line["correct"], line["checks"]
    assert line["checks"]["audio_ratio"]["value"] > line["checks"]["audio_ratio"]["limit"]


def test_cpu_line_names_no_card_metric(tmp_path):
    line = harness.execute(tiny_run("cje.train", tmp_path, trace=True))
    assert "idle_share.train" not in line["metrics"] and "mas_roofline" not in line["metrics"]
