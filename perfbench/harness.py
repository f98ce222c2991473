"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's entry in ``BENCHMARK.json`` names a
configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); the mix names its driver
(``perfbench/drivers/<driver>.py``), the cell's limits are in
``perfbench/checks/<cell>.json``, and each per-layer metric is read by
``perfbench/metrics/<metric>.py``. Adding any of them adds files and entries;
no file here changes.

A driver's ``run(run)`` builds the program from the configuration, drives
the window and checks the outputs; it returns a ``Outcome``. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from what the driver recorded.

The run exits non-zero, and prints no result, where no CUDA card is present
or fewer than the cell asks for, where the program's package is not beside
the benchmark, and where ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax`` or
``vits_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vits_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: its start in clock
    ticks after boot, against the uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start


@dataclasses.dataclass
class Check:
    """One number compared, its limit and which side passes."""

    name: str
    value: float
    limit: float
    at_most: bool = True

    @property
    def ok(self) -> bool:
        if self.value != self.value:  # NaN: no number, fails
            return False
        return self.value <= self.limit if self.at_most else self.value >= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""

    e2e: dict[str, float]
    attempted: int
    failed: int
    checks: list[Check]
    layer: dict  # what the per-layer readers read
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


@dataclasses.dataclass
class Run:
    """One run of one cell: its arguments and the files it found."""

    root: Path
    cell: dict
    config: object  # perfbench.cfg.Cfg
    config_path: Path
    traffic: object  # perfbench.cfg.Cfg
    limits: dict
    seed: int
    seconds: float
    trace: bool
    chips: int
    device: object = None
    setup_s: float | None = None
    raw: dict | None = None  # the readings a check compared, for perfbench/control.py

    def window_opens(self) -> None:
        """Set-up ends here: the time since process start is ``setup_s``."""
        self.setup_s = process_age_s()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_traffic(root: Path, name: str) -> Path:
    return root / "perfbench" / "traffic" / f"{name}.json"


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (end_to_end / per_layer) a cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def card() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi did not answer)"


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(args, root: Path = ROOT) -> Run:
    """Reads the cell's files; raises where one is missing."""
    from perfbench.cfg import Cfg, load

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise KeyError(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config_path = root / cfg_entry["file"]
    limits_path = root / "perfbench" / "checks" / f"{cell['name']}.json"
    return Run(
        root=root, cell=cell, config=load(config_path), config_path=config_path,
        traffic=Cfg(json.loads(find_traffic(root, cell["traffic"]).read_text())),
        limits=json.loads(limits_path.read_text()), seed=int(args.seed),
        seconds=float(args.seconds), trace=bool(args.trace), chips=int(cell["chips"]),
    )


def result_line(run: Run, bench: dict, out: Outcome, device_kind: str) -> dict:
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, run.cell["name"], kind):
        if kind == "end_to_end":
            value = run.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
        else:
            reader = load_module(run.root / "perfbench" / "metrics" / f"{m['name']}.py",
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.layer)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": run.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if run.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {
        "correct": all(c.ok for c in out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": device,
    }
    if run.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                               "passes_if": "at_most" if c.at_most else "at_least"}
                      for c in out.checks}
    return line


def execute(run: Run) -> dict:
    """Drives the cell on ``run.device`` and returns its result line (no
    look for a card: ``main`` makes it)."""
    driver = load_module(run.root / "perfbench" / "drivers" / f"{run.traffic.driver}.py",
                         "perfbench_driver_" + run.traffic.driver)
    out = driver.run(run)
    bench = json.loads((run.root / "BENCHMARK.json").read_text())
    kind = run.device.type
    if kind == "cuda":
        import torch

        kind = torch.cuda.get_device_name(run.device)
    line = result_line(run, bench, out, kind)
    for c in out.checks:
        side = "<=" if c.at_most else ">="
        print(f"check {c.name}: {c.value!r} (limit {side} {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILS'}", file=sys.stderr)
    return line


def main(argv=None) -> int:
    args = parse(argv)
    root = ROOT
    if not (root / "vits_torch").is_dir():
        print(f"perfbench: the program's package vits_torch is not beside the benchmark "
              f"in {root}", file=sys.stderr)
        return 2
    cache_dirs(root)
    run = prepare(args, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {run.cell['name']} needs {run.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    run.device = torch.device("cuda", 0)
    print(f"perfbench: card {card()}", file=sys.stderr)
    line = execute(run)
    loaded = forbidden_loaded()
    if loaded:
        print(f"perfbench: modules loaded that the port must not use: {loaded}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
