"""Batched serving with the PyTorch/CUDA port (the port's counterpart of
examples/serve_batched.py).

Starts the port's TTSEngine on the card (``--device cpu`` for the CPU),
optionally from a checkpoint the port's training run saved (``eval_{step}``)
or one converted from the JAX package's (see README.md), wraps it in
a DynamicBatcher, and pushes concurrent requests through it from client
threads, printing latency percentiles and throughput.

    python examples/serve_batched_torch.py --config configs/config_cje.yaml \\
        [--checkpoint runs/cje/eval_200000] [--requests 32] [--max-batch 8]

Each request draws its noise from a generator seeded with its own seed, so
its audio does not depend on the batch it is served in.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TEXTS = [
    "[EN]hello world, this is a batched request.[EN]",
    "[ZH]今天天气真不错。[ZH]",
    "[JA]今日はいい天気ですね。[JA]",
    "[P]ni3#hao3 shi4#jie4[P]",
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/config_cje.yaml")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-frames", type=int, default=1000)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    from vits_torch.serve.batcher import DynamicBatcher
    from vits_torch.serve.engine import TTSEngine

    engine = TTSEngine(args.config, checkpoint_path=args.checkpoint,
                       max_frames=args.max_frames, device=args.device)
    n_speakers = len(engine.hps.data.speakers)
    # one pass over the texts first, so the measured loop starts warm
    engine.synthesize_batch([{"text": t, "speaker_id": 0, "seed": 0} for t in TEXTS])
    batcher = DynamicBatcher(engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)

    latencies: list[float] = []
    samples: list[int] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        t0 = time.perf_counter()
        fut = batcher.submit(TEXTS[i % len(TEXTS)], speaker_id=i % n_speakers, seed=i)
        _, audio = fut.result()
        dt = time.perf_counter() - t0
        with lock:
            latencies.append(dt)
            samples.append(len(audio))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(args.requests)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.close()
    wall = time.perf_counter() - t0

    latencies.sort()
    n = len(latencies)
    if n != args.requests:
        raise RuntimeError(f"{args.requests - n} of {args.requests} requests failed")
    audio_s = sum(samples) / engine.sampling_rate
    print(
        f"{n} requests in {wall:.2f}s = {n / wall:.1f} req/s, {audio_s:.2f} s of audio | "
        f"latency p50 {latencies[n // 2] * 1e3:.0f} ms, "
        f"p95 {latencies[min(int(n * 0.95), n - 1)] * 1e3:.0f} ms ({engine.device})"
    )
    return dict(requests=n, wall_s=wall, audio_s=audio_s, latencies_s=latencies)


if __name__ == "__main__":
    main()
