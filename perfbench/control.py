"""The readings the cells' limits are set from: the control and the faults,
at a cell's own size, on the seeds given (``perfbench/checks.py`` says what
is compared; ``PERF.md`` gives the readings and the limits).

    python3 perfbench/control.py --workload cje.train --seeds 11,12,13 --modes fp8,half,dfrozen
    python3 perfbench/control.py --workload cje.serve --seeds 11,12,13 --modes bf16 --seconds 5
    python3 perfbench/control.py --workload cje.train --seeds 1,2,3 --modes program --seconds 2

Training cells: the reference in float32 with TF32 off is the yardstick;
``fp8`` is the control (the reference with the configuration's bf16 groups
in bfloat16 and every product's operands there rounded to float8 e4m3);
``half`` is a fault (the step computed on half the batch, the means taken
over it), and so is ``dfrozen`` (the discriminator's update undone, its
parameters left as they were). A group of leaves left unchanged reads 1 on
its ``delta_gap`` by the definition and needs no run. Serving cells: the
control is the program's own bfloat16 path (``TTSEngine(bf16=True)``)
driven through a short window at the cell's load. ``program`` reads the program's own numbers (a whole run of the cell
at ``--seconds``), many seeds in one process: the lower readings. One line
of JSON a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import checks, harness, traffic  # noqa: E402


def train_readings(run, modes, dump=None) -> list[dict]:
    from perfbench.drivers.train_step import program_hps, step_noise

    hps = program_hps(run.config)
    feed = traffic.TrainFeed(run.traffic, hps.data, run.seed, run.device)
    buckets = traffic.check_buckets(run.traffic)
    noise = lambda b, t: step_noise(run, hps, b, t)  # noqa: E731
    base = checks.reference_steps(run, hps, feed, noise, buckets)
    out = []
    for mode in modes:
        kw = {"fp8": dict(bf16=True, fp8=True),
              "half": dict(rows=int(run.traffic.batch) // 2),
              "dfrozen": dict(freeze_d=True)}[mode]
        other = checks.reference_steps(run, hps, feed, noise, buckets, **kw)
        out.append({"mode": mode, **checks.train_numbers(other, base,
                                                         checks.modules_named(run.limits)),
                    "worst": checks.worst_leaves(other, base)})
        if dump:
            write_raw(dump, run, mode, {"prog": other, "ref": base})
    return out


def write_raw(dump: str, run, mode: str, raw: dict) -> None:
    """The per-leaf readings behind a training line, as JSON."""
    path = Path(dump) / f"{run.cell['name']}.{run.seed}.{mode}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(raw))


def driver_readings(run, mode: str, dump=None) -> list[dict]:
    """The cell's own run (``program``), or a serving cell's run with the
    engine's bfloat16 path on (``bf16``)."""
    driver = harness.load_module(run.root / "perfbench" / "drivers" / f"{run.traffic.driver}.py",
                                 "perfbench_driver_control")
    out = driver.run(run, bf16=True) if mode == "bf16" else driver.run(run)
    if dump and run.raw:
        write_raw(dump, run, mode, run.raw)
    return [{"mode": mode, **{c.name: c.value for c in out.checks}}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", required=True,
                    help="program, fp8, half, dfrozen (train), bf16 (serve)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dump", help="a directory for the per-leaf readings of training lines")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 3
    harness.cache_dirs(harness.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
        run = harness.prepare(ns)
        run.device = torch.device("cuda", 0)
        modes = args.modes.split(",")
        rows = []
        for mode in ("program", "bf16"):
            if mode in modes:
                rows += driver_readings(run, mode, args.dump)
        ref_modes = [m for m in modes if m in ("fp8", "half", "dfrozen")]
        if ref_modes:
            rows += train_readings(run, ref_modes, args.dump)
        for r in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
