"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell with new files and new entries of ``BENCHMARK.json`` alone: in a
copy of the benchmark, each is added and the new cell runs on the CPU, with
no file of the copy edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench.tests.tiny import ROOT, TINY_MODEL, TINY_TRAFFIC

RUNNER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from perfbench import harness
import argparse
from pathlib import Path
root = Path(sys.argv[1])
run = harness.prepare(argparse.Namespace(workload="dummy.cell", seed=2**31 + 99, seconds=1.0,
                                         trace=int(sys.argv[2])), root)
run.device = torch.device("cpu")
print(json.dumps(harness.execute(run)))
"""


def digest(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(ROOT / "vits_torch", root / "vits_torch")
    before = digest(root / "perfbench")

    cfg = json.loads((ROOT / "perfbench/configs/cje.json").read_text())
    cfg["name"] = "dummy"
    cfg["train"].update(segment_size=2048, bf16_run=False)
    cfg["model"].update(TINY_MODEL)
    (root / "perfbench/configs/dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "perfbench/traffic/cje_train_buckets.json").read_text())
    mix.update(TINY_TRAFFIC["cje_train_buckets"])
    (root / "perfbench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "perfbench/checks/dummy.cell.json").write_text(
        (ROOT / "perfbench/checks/cje.train.json").read_text())
    (root / "perfbench/metrics/dummy.metric.py").write_text(
        '"""dummy.metric: steps in the window."""\n\n\ndef read(ctx):\n    return ctx["steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "perfbench/configs/dummy.json", "reduced": [],
                             "why": "a configuration added by new files alone"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a cell added by new files alone"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "training.step",
                               "moves": "train_audio_s_per_s", "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_audio_s_per_s":
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    lines = {}
    for trace in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", RUNNER, str(root), trace], cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
    assert lines["0"]["correct"] and lines["1"]["correct"]
    assert set(lines["0"]["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert lines["1"]["metrics"]["dummy.metric"]["value"] >= 1
    after = digest(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before
