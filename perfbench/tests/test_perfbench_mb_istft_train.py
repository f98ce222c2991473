"""The cell ``ljs_mbistft.train`` on the CPU at test widths: run from its own
files in a copy of the benchmark whose other files and entries are left as
they were (the test widths handed in memory), correct on the program; its
control (the step under bfloat16 autocast) and each fault of the checked
steps (half the batch, D's update undone, the sub-band loss left out) failing
at least one number under the cell's limits; its readers; the reference's
FLOP count on the ``meta`` device."""

from __future__ import annotations

import argparse
import importlib
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

CELL = "ljs_mbistft.train"
CONFIG = "ljs_mbistft_train"
METRICS = ("disc.share.ljs_train", "loss.subband_ms.ljs_train")
LISTED = ("train_audio_s_per_s", "train_mfu", "train.peak_gib", "mas_roofline",
          "idle_share.train")
NEW_FILES = ["perfbench/configs/ljs_mbistft_train.json", "perfbench/traffic/ljs_train_buckets.json", "perfbench/drivers/train_step_mbistft.py",
             "perfbench/checks/ljs_mbistft.train.json", "perfbench/control_mbistft.py",
             "perfbench/reference/mb_istft_train.py", "perfbench/reference/models/mpd.py",
             "perfbench/reference/training/stft_loss.py"] + [
    f"perfbench/metrics/{m}.py" for m in METRICS]
TEST_WIDTHS = dict(inter_channels=96, hidden_channels=48, filter_channels=64, n_layers=1,
                   resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
                   upsample_initial_channel=32, posterior_layers=2, flow_n_flows=1,
                   flow_wn_layers=1, dur_n_flows=1, discriminator_size="probe")
TEST_TRAFFIC = dict(batch=4, text_pad=32, max_ids=31, cycle={"40": 2, "48": 1},
                    frames={"40": [30, 40], "48": [41, 48]}, ref_block=2, traced_steps=1)
RUNNER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from perfbench.tests.test_perfbench_mb_istft_train import cell_run
from pathlib import Path
run = cell_run(Path(sys.argv[1]), Path(sys.argv[2]), trace=bool(int(sys.argv[3])))
from perfbench import harness
print(json.dumps(harness.execute(run)))
"""


def cell_run(root, tmp, trace: bool = False, seed: int = 2**31 + 22) -> harness.Run:
    """The cell's run as ``root``'s files give it, on the CPU, its model at
    test widths (a configuration written to ``tmp``) and batches of 4 rows."""
    run = harness.prepare(argparse.Namespace(workload=CELL, seed=seed, seconds=1.0,
                                             trace=int(trace)), root)
    cfg = json.loads(run.config_path.read_text())
    cfg["model"].update(TEST_WIDTHS)
    cfg["train"]["segment_size"] = 2048
    path = tmp / "ljs_mbistft.train_test.json"
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


def without_the_cell(bench: dict) -> dict:
    """``BENCHMARK.json`` without this cell's entries."""
    out = json.loads(json.dumps(bench))
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"] if m["name"] not in METRICS]
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    return out


def with_the_cell(bench: dict, config: dict, cell: dict, metrics: list[dict]) -> dict:
    """The entries appended as this cell adds them."""
    out = json.loads(json.dumps(bench))
    out["configs"].append(config)
    out["workloads"].append(cell)
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in LISTED:
            m["workloads"].append(CELL)
    out["per_layer"] += metrics
    return out


def test_the_cell_only_appends_entries():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(c for c in bench["configs"] if c["name"] == CONFIG)
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    metrics = [m for m in bench["per_layer"] if m["name"] in METRICS]
    assert cell["chips"] == 1 and cell["config"] == CONFIG
    assert [m["workloads"] for m in metrics] == [[CELL], [CELL]]
    assert with_the_cell(without_the_cell(bench), config, cell, metrics) == bench


def test_the_training_configuration_holds_the_serving_numbers():
    """The training file is the published file that ``ljs_mbistft.json`` holds
    for serving, under another source (the training script) and reference:
    every number, the cut and the assumptions alike."""
    from perfbench.reference import mb_istft_train

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {c["name"]: c for c in bench["configs"]}
    train = json.loads((ROOT / entries[CONFIG]["file"]).read_text())
    serve = json.loads((ROOT / entries["ljs_mbistft"]["file"]).read_text())
    own = {"name", "source", "reference", "note"}
    assert set(train) == set(serve)
    assert {k: v for k, v in train.items() if k not in own} == \
        {k: v for k, v in serve.items() if k not in own}
    assert train["name"] == CONFIG and train["source"] == entries[CONFIG]["source"]
    assert train["source"] != serve["source"]
    assert entries[CONFIG]["reduced"] == train["reduced"] == ["symbols"]
    module, name = train["reference"].split(":")
    assert getattr(importlib.import_module(module), name) is mb_istft_train.build


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_from_its_new_files(trace, tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in NEW_FILES:
        (root / f).unlink()
    (root / "BENCHMARK.json").write_text(json.dumps(without_the_cell(bench)))
    os.symlink(ROOT / "vits_torch", root / "vits_torch")
    before = digest(root / "perfbench")
    for f in NEW_FILES:  # the cell's files, added
        shutil.copy(ROOT / f, root / f)
    config = next(c for c in bench["configs"] if c["name"] == CONFIG)
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(with_the_cell(
        without_the_cell(bench), config, cell,
        [m for m in bench["per_layer"] if m["name"] in METRICS])))
    out = subprocess.run([sys.executable, "-c", RUNNER, str(root), str(tmp_path), str(trace)],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"g_loss_gap", "d_loss_gap", "subband_gap", "delta_gap",
                                   "delta_gap.d", "delta_worst", "delta_worst.d", "mas_path_off",
                                   "dropout_sites"}
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:  # no device trace on the CPU: the readers of the profiled stretch read nothing
        assert "train_mfu" not in line["metrics"] and not set(METRICS) & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    after = digest(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("mode", ["bf16", "half", "dfrozen", "nosubband"])
def test_control_and_faults_fail_a_number(mode, tmp_path):
    from perfbench import control_mbistft

    run = cell_run(ROOT, tmp_path)
    got = control_mbistft.reading(run, mode)
    lim = run.limits
    assert not got["correct"], got
    assert [k for k in lim if got[k] > lim[k]], got


@pytest.mark.parametrize("side", ["g", "d"])
def test_one_leaf_left_still_fails_its_worst_leaf(side):
    """One moved leaf's update undone reads 1 on its side's worst leaf, over
    the limit, while the median of the side's leaves stays at 0."""
    from perfbench.drivers import train_step_mbistft as drv

    leaves = [f"{s}.layer{i}.weight" for s in "gd" for i in range(5)]
    ref = {"losses": [(1.0, 1.0)], "subband": [1.0], "grads": dict.fromkeys(leaves, 1.0),
           "deltas": dict.fromkeys(leaves, 0.01)}
    prog = {**ref, "deltas": {**ref["deltas"], f"{side}.layer3.weight": 0.0}}
    got = drv.numbers(prog, ref)
    lim = json.loads((ROOT / "perfbench/checks/ljs_mbistft.train.json").read_text())
    worst, median = drv.DELTA_NAMES[side + "."][1], drv.DELTA_NAMES[side + "."][0]
    assert got[worst] == 1.0 > lim[worst] and got[median] == 0.0
    assert all(got[k] == 0.0 for k in lim if k in got and k not in (worst, median))


def test_program_reading_is_correct(tmp_path):
    from perfbench import control_mbistft

    got = control_mbistft.reading(cell_run(ROOT, tmp_path, seed=2**33 + 5), "program")
    assert got["correct"], got


def test_readers():
    read = {m: harness.load_module(ROOT / "perfbench" / "metrics" / f"{m}.py",
                                   "r_" + m.replace(".", "_")).read for m in METRICS}
    ctx = {"traced_steps": 3, "trace": {"busy_s": 2.0, "spans": {
        "disc": {"count": 12, "device_s": 0.5}, "subband_loss": {"count": 6, "device_s": 0.006}}}}
    assert read["disc.share.ljs_train"](ctx) == pytest.approx(25.0)
    assert read["loss.subband_ms.ljs_train"](ctx) == pytest.approx(2.0)
    for r in read.values():  # a parent without the spans, or a run without a trace
        assert r({"traced_steps": 3, "trace": {"busy_s": 2.0, "spans": {}}}) is None
        assert r({"steps": 4}) is None


def test_reference_flops_on_meta(tmp_path):
    from perfbench.drivers import train_step_mbistft as drv

    run = cell_run(ROOT, tmp_path)
    models = drv.build_reference(run.config, "meta")
    small, large = (drv.ref_flops_of(run, b, models) for b in (40, 48))
    assert 0 < small <= large
