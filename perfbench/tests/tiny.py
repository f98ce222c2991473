"""Tiny cells for the CPU tests: the configurations of ``perfbench/configs``
at test widths, the mixes at a few rows, and a ``Run`` on the CPU."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import torch

from perfbench import harness
from perfbench.cfg import Cfg

ROOT = Path(__file__).resolve().parents[2]
TINY_MODEL = dict(
    inter_channels=96, hidden_channels=48, filter_channels=64, n_heads=2, n_layers=1,
    resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], upsample_initial_channel=32,
    gin_channels=16, posterior_layers=2, flow_n_flows=1, flow_wn_layers=1, dur_n_flows=1,
    yin_dec_layers=2, discriminator_size="probe",
)
TINY_TRAFFIC = {
    "cje_train_buckets": dict(batch=4, text_pad=32, max_ids=31, cycle={"40": 2, "48": 1},
                              frames={"40": [30, 40], "48": [41, 48]}, ref_block=2,
                              traced_steps=1),
    "cje_long_train_buckets": dict(batch=4, text_pad=48, max_ids=48, ids=[20, 48],
                                   cycle={"56": 1}, frames={"56": [49, 56]}, ref_block=2,
                                   traced_steps=1),
    "cje_sentences_8rps": dict(rate_per_s=6.0, bank_size=20, sample=3, warm_s=0.5,
                               traced_s=0.5),
    "cje_paragraphs_closed": dict(paragraphs=3, sample=1, traced_requests=1),
}


# cells whose parts are in perfbench/ but which BENCHMARK.json does not list
# (PERF.md, Open questions): their drivers are tested all the same
UNLISTED = {
    "cje.serve": {"name": "cje.serve", "config": "cje", "traffic": "cje_sentences_8rps",
                  "chips": 1, "why": "open loop through DynamicBatcher"},
}


def tiny_config(name: str, tmp: Path, bf16: bool | None = None) -> Path:
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    cfg["train"]["segment_size"] = 2048
    if bf16 is not None:
        cfg["train"]["bf16_run"] = bf16
    cfg["model"].update(TINY_MODEL)
    path = tmp / f"{name}.tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def tiny_run(cell: str, tmp: Path, seed: int = 2**31 + 17, seconds: float = 1.0,
             trace: bool = False, bf16: bool | None = False) -> harness.Run:
    """The cell of ``BENCHMARK.json`` at test size on the CPU; train cells in
    float32 unless ``bf16`` says otherwise (the CPU's bf16 is not the card's)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None) or UNLISTED[cell]
    path = tiny_config(entry["config"], tmp, bf16)
    tr = json.loads(harness.find_traffic(ROOT, entry["traffic"]).read_text())
    tr.update(copy.deepcopy(TINY_TRAFFIC[entry["traffic"]]))
    limits = json.loads((ROOT / "perfbench" / "checks" / f"{cell}.json").read_text())
    run = harness.Run(root=ROOT, cell=entry, config=Cfg(json.loads(path.read_text())),
                      config_path=path, traffic=Cfg(tr), limits=limits, seed=seed,
                      seconds=seconds, trace=trace, chips=1)
    run.device = torch.device("cpu")
    return run
