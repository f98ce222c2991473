"""The controls on the card, at each cell's own size: the reference in the
precision below the configuration's (training) or the program's own
bfloat16 path (serving) has to fail at least one of the cell's limits; and
so does each fault of a training cell read on the reference (half the
batch; the discriminator's update undone). Card only:

    python -m pytest perfbench/tests/test_perfbench_control.py -m cuda
"""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from perfbench import control, harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    harness.cache_dirs(harness.ROOT)
    run = harness.prepare(argparse.Namespace(workload=cell, seed=2**31 + 404, seconds=5.0,
                                             trace=0))
    run.device = torch.device("cuda", 0)
    if run.traffic.kind == "train_buckets":
        rows = control.train_readings(run, ["fp8", "half", "dfrozen"])
    else:
        rows = control.driver_readings(run, "bf16")
    for row in rows:
        failed = [k for k, v in row.items() if k in run.limits
                  and not v <= run.limits[k]]
        assert failed, row
