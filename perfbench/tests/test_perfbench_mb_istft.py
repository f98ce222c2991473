"""The cell ``ljs_mbistft.serve_long`` on the CPU at test widths: run from
its own files in a copy of the benchmark (none of them edited, the test
widths handed in memory), its fault (the audio x 1.01) failing
``audio_ratio`` where the exact run passes, its readers, and the reference
its configuration names."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.cfg import Cfg
from perfbench.tests.test_perfbench_extend import digest
from perfbench.tests.tiny import ROOT

CELL = "ljs_mbistft.serve_long"
TEST_WIDTHS = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
                   resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                   upsample_initial_channel=32, posterior_layers=2, flow_n_flows=1,
                   flow_wn_layers=1, dur_n_flows=1)
TEST_TRAFFIC = dict(paragraphs=3, sample=1, traced_requests=1)
RUNNER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from perfbench.tests.test_perfbench_mb_istft import cell_run
from pathlib import Path
run = cell_run(Path(sys.argv[1]), Path(sys.argv[2]), trace=bool(int(sys.argv[3])))
from perfbench import harness
print(json.dumps(harness.execute(run)))
"""


def cell_run(root, tmp, trace: bool = False, seed: int = 2**31 + 18) -> harness.Run:
    """The cell's run as ``root``'s files give it, on the CPU, its model at
    test widths (a configuration written to ``tmp``) and a few paragraphs."""
    run = harness.prepare(argparse.Namespace(workload=CELL, seed=seed, seconds=1.0,
                                             trace=int(trace)), root)
    cfg = json.loads(run.config_path.read_text())
    cfg["model"].update(TEST_WIDTHS)
    path = tmp / "ljs_mbistft.test.json"
    path.write_text(json.dumps(cfg))
    run.config, run.config_path = Cfg(cfg), path
    run.traffic.update(TEST_TRAFFIC)
    run.device = torch.device("cpu")
    return run


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_from_its_files(trace, tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "vits_torch", root / "vits_torch")
    before = digest(root)
    out = subprocess.run([sys.executable, "-c", RUNNER, str(root), str(tmp_path), str(trace)],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"ids_off", "frames_off", "audio_ratio"}
    if trace:  # the device's stretches run on a card alone: nothing to read here
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("fault", [False, True])
def test_audio_times_1_01_fails_and_the_exact_run_passes(fault, tmp_path, monkeypatch):
    from vits_torch.models.synthesizer import SynthesizerTrn

    if fault:
        real = SynthesizerTrn.infer

        def infer(self, *a, **kw):
            wav, mask, lengths = real(self, *a, **kw)
            return wav * 1.01, mask, lengths

        monkeypatch.setattr(SynthesizerTrn, "infer", infer)
    line = harness.execute(cell_run(ROOT, tmp_path))
    ratio = line["checks"]["audio_ratio"]
    assert line["correct"] is not fault, line["checks"]
    assert (ratio["value"] > ratio["limit"]) is fault
    assert line["checks"]["ids_off"]["value"] == line["checks"]["frames_off"]["value"] == 0


def _reader(name):
    return harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py", "t_" + name)


def test_readers_of_the_cell():
    device_ms, share = _reader("engine.device_ms.ljs"), _reader("decoder.share.ljs")
    ctx = {"traced_requests": 2,
           "trace": {"spans": {"infer": {"count": 8, "device_s": 0.03}}},
           "eager_trace": {"spans": {"infer_eager": {"count": 4, "device_s": 0.02},
                                     "decode": {"count": 4, "device_s": 0.015}}}}
    assert device_ms.read(ctx) == pytest.approx(15.0)
    assert share.read(ctx) == pytest.approx(75.0)
    for empty in ({}, {"trace": {}, "eager_trace": {}, "traced_requests": 2}):
        assert device_ms.read(empty) is None and share.read(empty) is None


def test_the_configuration_names_its_reference():
    from perfbench.drivers.synth_closed_loop_ref import reference_builder
    from perfbench.reference.models import mb_istft
    from perfbench import weights
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer

    path = ROOT / "perfbench" / "configs" / "ljs_mbistft.json"
    cfg = Cfg(json.loads(path.read_text()))
    assert reference_builder(cfg) is mb_istft.build
    with torch.device("meta"):
        ref = mb_istft.MBISTFTSynthesizer(cfg, 71)
        prog = build_synthesizer(load_hparams(str(path)), device="meta")
    assert weights.shapes_of(ref) == weights.shapes_of(prog)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "ljs_mbistft")
    assert entry["reduced"] == cfg.reduced == ["symbols"]
    assert set(cfg.assumed) == {"use_sdp", "pqmf_cutoff_ratio"}
    assert mb_istft.PQMF_CUTOFF == cfg.assumed["pqmf_cutoff_ratio"]
