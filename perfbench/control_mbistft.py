"""The readings ``ljs_mbistft.train``'s limits are set from: the cell's run on
the seeds given, as the program (``program``), under its control (``bf16``:
the program's step under bfloat16 autocast, the precision below the
configuration's float32) and under each fault of its checked steps (``half``,
``dfrozen``, ``nosubband``: see ``perfbench/drivers/train_step_mbistft.py``).
Each reading is a whole run of the cell's driver at ``--seconds``; one line of
JSON a reading, with every number the driver computes (``numbers``: those
the limits name and the worst leaves' gaps) and, per side, the three moved
leaves whose change is furthest from the reference's.

    python3 perfbench/control_mbistft.py --seeds 11,12,13 --modes bf16,half,dfrozen,nosubband --seconds 2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402

CELL = "ljs_mbistft.train"
MODES = ("program", "bf16", "half", "dfrozen", "nosubband")


def reading(run, mode: str) -> dict:
    driver = harness.load_module(run.root / "perfbench" / "drivers" / f"{run.traffic.driver}.py",
                                 "perfbench_driver_control_mbistft")
    kw = {"program": {}, "bf16": {"bf16": True}}.get(mode, {"fault": mode})
    out = driver.run(run, **kw)
    row = {"mode": mode, "correct": all(c.ok for c in out.checks),
           **{c.name: c.value for c in out.checks}}
    if run.raw:  # every number, the limited or not, and the leaves that set the worst
        prog, ref = run.raw["prog"], run.raw["ref"]
        row.update(driver.numbers(prog, ref))
        row["worst"] = {side: [[k, g, p, r] for g, k, p, r in top]
                        for side, (_, top) in driver.worst_leaves(prog, ref).items()}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", required=True, help=", ".join(MODES))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - set(MODES):
        ap.error(f"modes are {MODES}")
    import torch

    if not torch.cuda.is_available():
        print("control_mbistft.py: no CUDA card", file=sys.stderr)
        return 3
    harness.cache_dirs(harness.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            ns = argparse.Namespace(workload=CELL, seed=seed, seconds=args.seconds, trace=0)
            run = harness.prepare(ns)
            run.device = torch.device("cuda", 0)
            print(json.dumps({"workload": CELL, "seed": seed, **reading(run, mode)}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
