"""The rate sweep that fixed an open-loop cell's rate: the cell's engine
and batcher once, then the cell's traffic at each rate for ``--seconds``.

    python3 perfbench/sweep.py --workload cje.serve --seed 5 --rates 20,40,60 --seconds 15

One JSON line a rate: requests sent, finished a second, p50 and p95 ms, and
the backlog's growth (median latency of the window's last third over its
first third). The knee is the highest rate whose backlog does not grow
(growth under 1.5 and every request done within 2 s of the close); the cell
runs at four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, traffic  # noqa: E402
from perfbench.cfg import Cfg  # noqa: E402
from perfbench.drivers import serve_open_loop as sol  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch
    from vits_torch.serve.batcher import DynamicBatcher

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA card", file=sys.stderr)
        return 3
    harness.cache_dirs(harness.ROOT)
    run = harness.prepare(argparse.Namespace(workload=args.workload, seed=args.seed,
                                             seconds=args.seconds, trace=0))
    run.device = torch.device("cuda", 0)
    engine = sol.build_engine(run)
    sol.warm(engine, [t for t, _ in traffic.sentence_bank(run.traffic)])
    batcher = DynamicBatcher(engine)
    lock = threading.Lock()
    for rate in (float(r) for r in args.rates.split(",")):
        tr = Cfg({**run.traffic, "rate_per_s": rate})
        reqs = traffic.open_loop(tr, args.seed, args.seconds)
        done: dict = {}
        t0 = time.perf_counter()
        futs = sol.drive(batcher, reqs, t0, done, lock)
        close = time.perf_counter()
        lat = []
        for i, f in futs.items():
            try:
                f.result(timeout=60)
                lat.append(done[i] - (t0 + reqs[i]["due"]))
            except Exception:  # noqa: BLE001 - a failure counts as over every limit
                lat.append(float("inf"))
        end = max(done.values()) if done else close
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate_per_s": rate, "sent": len(reqs), "done_per_s": len(done) / (end - t0),
            "p50_ms": sol.percentile(lat, 50) * 1e3, "p95_ms": sol.percentile(lat, 95) * 1e3,
            "growth": statistics.median(lat[-third:]) / statistics.median(lat[:third]),
            "drain_s": end - close}), flush=True)
    batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
