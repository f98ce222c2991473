"""Training-step throughput of the PyTorch/CUDA port on the flagship config,
one card (the port's counterpart of bench_train.py).

    python3 bench_train_torch.py [--batch 16] [--frames 400] [--text 128]
        [--iters 10] [--bf16] [--remat] [--trace DIR]
        [--device cuda|cpu] [--config configs/config_cje.yaml]

Prints a JSON line with bench_train.py's keys: steps/s and seconds of audio
trained per second of training/step.py::train_step on bench.py's synthetic
batch (random weights from torch.manual_seed(0), the config's discriminator,
flagship for config_cje). ``init_s`` is the time to build the generator, the
discriminator and their optimizers. ``compile_s`` is the first step's wall:
eager PyTorch compiles nothing, so it holds the first call's costs instead
(cuDNN and cuBLAS handles and plans, lazy loading of CUDA modules, the
caching allocator's growth). ``--trace DIR`` writes a torch.profiler Chrome
trace of the timed loop to DIR/trace.json (utils/profiling.py::trace).

The first stderr line names the device; the last is a JSON object with the
train steps run and the MAS kernels' launch counts. Without a card and
without --device cpu the script exits non-zero before it builds a model.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from bench_torch import (DEFAULT_CONFIG, bench_device, build_train_state, device_label,
                         report_launches, sync, train_batch)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--frames", type=int, default=400)
    parser.add_argument("--text", type=int, default=128)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="gradient rematerialization (train.remat_run)")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the timed loop into DIR")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    args = parser.parse_args(argv)
    dev = bench_device(args.device, "bench_train_torch.py")

    from vits_torch.config import load_hparams
    from vits_torch.training.step import train_step
    from vits_torch.utils.profiling import trace

    print(f"bench_train_torch.py: {device_label(dev)}", file=sys.stderr)
    hps = load_hparams(args.config)
    if args.remat:
        hps.train["remat_run"] = True
    b, tx, ty, hop = args.batch, args.text, args.frames, hps.data.hop_length
    batch = train_batch(np.random.default_rng(0), hps, b, tx, ty, dev)

    t0 = time.perf_counter()
    state = build_train_state(hps, dev, args.bf16)
    sync(dev)
    init_s = time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    metrics = train_step(state, batch, hps, generator=gen)
    sync(dev)
    compile_s = time.perf_counter() - t0

    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            metrics = train_step(state, batch, hps, generator=gen)
        sync(dev)
        elapsed = time.perf_counter() - t0

    steps_per_sec = args.iters / elapsed
    audio_sec_per_step = b * ty * hop / hps.data.sampling_rate
    report_launches("bench_train_torch.py", state.step)
    print(json.dumps({
        "metric": "train_steps_per_sec",
        "bf16": args.bf16,
        "value": steps_per_sec,
        "unit": "steps/s",
        "batch": b,
        "frames": ty,
        "audio_sec_per_sec": steps_per_sec * audio_sec_per_step,
        "init_s": init_s,
        "compile_s": compile_s,
        "loss_g": float(metrics["loss/g/total"]),
        "loss_d": float(metrics["loss/d/total"]),
    }))


if __name__ == "__main__":
    main()
