#!/usr/bin/env python3
"""Where a request served from a new thread loses its time on the card.

``TTSEngine.synthesize`` called from a thread that has not used the card yet
(each handler thread of ``serve/http_api.py``'s ThreadingHTTPServer is one)
takes far longer than from the main thread. This probe builds the full-width
engine of configs/config_cje.yaml (random weights from the seed), warms it up
on the main thread, then, in each of three new threads, times one after the
other (host clock, synchronized): a small tensor on the card, a cuDNN
convolution, a cuBLAS matmul, a CUDA generator's draw, and two
``synthesize`` calls. The same steps on the warm main thread are the
reference.

    python3 tools/probe_serve_threads.py [--seed N]

Needs a CUDA device. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the card line and the texts)

TEXT = chip_smoke.SERVE_TEXTS["EN"]


def steps(eng, seed):
    """[(name, ms)] of each step, in order, on the calling thread."""
    x = torch.randn(1, 192, 400, device="cuda")
    w = torch.randn(192, 192, 5, device="cuda")
    a = torch.randn(512, 512, device="cuda")
    torch.cuda.synchronize()
    work = (
        ("tensor", lambda: torch.ones(4, device="cuda")),
        ("conv1d", lambda: torch.nn.functional.conv1d(x, w, padding=2)),
        ("matmul", lambda: a @ a),
        ("generator", lambda: torch.randn(
            1000, 192, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(seed))),
        ("synthesize 1", lambda: eng.synthesize(TEXT, 2, seed)),
        ("synthesize 2", lambda: eng.synthesize(TEXT, 2, seed)),
    )
    out = []
    for name, fn in work:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((name, (time.perf_counter() - t0) * 1e3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_serve_threads: needs a CUDA device", file=sys.stderr)
        return 2
    from vits_torch.serve.engine import TTSEngine

    card = chip_smoke.card_line()
    torch.manual_seed(args.seed)
    eng = TTSEngine(str(ROOT / "configs" / "config_cje.yaml"), max_frames=1000)
    steps(eng, args.seed)  # warm the main thread
    rows = [("main thread", steps(eng, args.seed))]
    for i in range(3):
        got = []
        th = threading.Thread(target=lambda: got.append(steps(eng, args.seed)))
        th.start()
        th.join(timeout=300)
        if not got:
            raise SystemExit("probe_serve_threads: a thread failed")
        rows.append((f"new thread {i + 1}", got[0]))
    for label, row in rows:
        print(f"{card} | {label}: " + ", ".join(f"{n} {ms:.2f} ms" for n, ms in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
