"""Driver of the open-loop serving cell: ``DynamicBatcher(engine)`` at its
defaults over ``TTSEngine`` at its defaults (float32, ``max_frames`` 1000),
as ``serve/http_api.py`` builds them, the engine handed the benchmark's
seeded weights and its noise (``noise_fn``: each request's draws from its
own seed, cut from fixed-size draws so that a position's noise does not
depend on the bucket).

Set-up builds the engine, loads the weights, and warms every (text bucket,
frame bucket, batch bucket) the mix's sentences can reach, through
``synthesize_batch`` and the single-request path. The window submits the
mix's requests at their due times (an open loop: Poisson arrivals at the
mix's fixed rate, from the main thread, which sleeps between them) for
``--seconds``, then waits for every request due in it (at most ``drain_s``).

End to end: ``serve_p95_ms``, the 95th percentile (nearest rank) of the
latency of every request due in the window, from when it was due to when its
audio was on the host (the batcher's future resolved); a request that failed
or never finished counts as over every limit.

Traced (``--trace 1``): spans around ``engine.get_phoneme`` (g2p),
``engine.synthesize_batch`` (a flush: its start is when each of its
requests left the queue) and ``engine.model.infer`` (calls) during the
window; then a profiled stretch of ``traced_s`` seconds more of the loop.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from perfbench import checks, device as devmod, randomness, tracing, traffic, weights
from perfbench.harness import Outcome


def build_engine(run, bf16: bool = False):
    from vits_torch.serve.engine import TTSEngine

    dev = run.device
    with torch.device(dev):
        engine = TTSEngine(str(run.config_path), None, max_frames=int(run.traffic.max_frames),
                           bf16=bf16, device=dev,
                           noise_fn=lambda seed, shapes: randomness.serve_noise(seed, shapes, dev))
    shapes = {f"g.{k}": v for k, v in weights.shapes_of(engine.model).items()}
    weights.load(engine.model, {k[2:]: v for k, v in weights.make(shapes, run.seed, dev).items()})
    return engine


def record_ids(engine, ids: dict):
    """Keep what the engine's frontend made of each text (the first time)."""
    original = engine.get_phoneme

    def get_phoneme(text):
        out = original(text)
        ids.setdefault(text, np.array(out[0]))
        return out

    engine.get_phoneme = get_phoneme


def warm(engine, texts: list[str]) -> None:
    """Every (text bucket, frame bucket) class of ``texts`` at every batch
    bucket it can fill, and each class alone (the single-request path)."""
    classes: dict[tuple, list[str]] = {}
    for text in texts:
        n = len(engine.get_phoneme(text)[0])
        key = (engine._bucket(n), engine._first_frames(n, 1.0)) if n <= engine.TEXT_BUCKETS[-1] \
            else ("long", n)
        classes.setdefault(key, []).append(text)
    for members in classes.values():
        for nb in engine.BATCH_BUCKETS:
            k = min(nb, len(members))
            if next(b for b in engine.BATCH_BUCKETS if b >= k) == nb:
                engine.synthesize_batch([{"text": t, "seed": i} for i, t in enumerate(members[:k])])


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (inf where the rank falls on a failure)."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def drive(batcher, requests: list[dict], t0: float, done: dict, lock) -> dict:
    """Submit each request at t0 + due; returns index -> future."""
    futs = {}
    for i, r in enumerate(requests):
        wait = t0 + r["due"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

        def finished(_f, i=i):
            with lock:
                done[i] = time.perf_counter()

        f = batcher.submit(r["text"], speaker_id=r["speaker_id"], seed=r["seed"])
        f.add_done_callback(finished)
        futs[i] = f
    return futs


def run(run, bf16: bool = False):
    from vits_torch.serve.batcher import DynamicBatcher

    dev, tr = run.device, run.traffic
    engine = build_engine(run, bf16)
    ids: dict[str, np.ndarray] = {}
    record_ids(engine, ids)
    bank = [t for t, _ in traffic.sentence_bank(tr)]
    warm(engine, bank)
    batcher = DynamicBatcher(engine)
    warm_reqs = traffic.open_loop(tr, randomness.subseed(run.seed, "warm"), float(tr.warm_s))
    lock = threading.Lock()
    warm_done: dict = {}
    for f in drive(batcher, warm_reqs, time.perf_counter(), warm_done, lock).values():
        f.exception()
    devmod.sync(dev)

    spans = tracing.Spans()
    flush_start: dict[int, float] = {}
    undo = []
    if run.trace:
        def on_flush(args, kwargs, result, t0, t1):
            for req in args[0]:
                flush_start.setdefault(req["seed"], t0)

        undo.append(tracing.wrap(engine, "get_phoneme", "g2p", spans))
        undo.append(tracing.wrap(engine, "synthesize_batch", "flush", spans, on_flush))
        undo.append(tracing.wrap(engine.model, "infer", "infer", spans))
    devmod.reset_peak(dev)

    # -- the window --------------------------------------------------------
    reqs = traffic.open_loop(tr, run.seed, run.seconds + float(tr.traced_s))
    in_window = [r for r in reqs if r["due"] < run.seconds]
    after = [dict(r, due=r["due"] - run.seconds) for r in reqs if r["due"] >= run.seconds]
    done: dict[int, float] = {}
    run.window_opens()
    t0 = time.perf_counter()
    futs = drive(batcher, in_window, t0, done, lock)
    late = time.perf_counter() - (t0 + (in_window[-1]["due"] if in_window else 0.0))
    deadline = time.perf_counter() + float(tr.drain_s)
    audio, failed, lat = {}, 0, []
    for i, f in futs.items():
        try:
            _, audio[i] = f.result(timeout=max(0.0, deadline - time.perf_counter()))
            with lock:
                lat.append(done[i] - (t0 + in_window[i]["due"]))
        except Exception:  # failed or not finished: over every limit
            failed += 1
            lat.append(float("inf"))
    window_s = time.perf_counter() - t0
    infer_calls = spans.count("infer")
    layer = {"requests": len(in_window), "window_s": window_s, "generator_late_s": late,
             "infer_calls": infer_calls, "g2p_s": spans.total("g2p"),
             "g2p_calls": spans.count("g2p")}
    if run.trace:
        waits = [flush_start[r["seed"]] - (t0 + r["due"]) for r in in_window
                 if r["seed"] in flush_start]
        layer["queue_s"] = sum(waits) / len(waits) if waits else None
    memory_peak = devmod.peak_bytes(dev)

    out_trace = {}
    if run.trace and dev.type == "cuda":
        def traced():
            t1 = time.perf_counter()
            for f in drive(batcher, after, t1, {}, lock).values():
                f.exception()

        out_trace = tracing.profile(traced)
    layer["trace"] = out_trace
    for u in undo:
        u()
    batcher.close()
    del engine, batcher
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------------
    finished = sorted(audio)
    rng = np.random.default_rng(randomness.subseed(run.seed, "sample"))
    pick = set(rng.choice(finished, size=min(int(tr.sample), len(finished)), replace=False).tolist()) \
        if finished else set()
    if finished:
        pick.add(max(finished, key=lambda i: len(audio[i])))
    records = [dict(in_window[i], audio=audio[i], ids=ids.get(in_window[i]["text"]))
               for i in sorted(pick)]
    nums = checks.serve_numbers(run, hps_of(run), records,
                                lambda seed, shapes: randomness.serve_noise(seed, shapes, dev))
    return Outcome(
        e2e={"serve_p95_ms": percentile(lat, 95) * 1e3},
        attempted=len(in_window), failed=failed, checks=checks.serve_checks(nums, run.limits),
        layer=layer, memory_peak_bytes=memory_peak,
        busy_s=out_trace.get("busy_s"), window_s=out_trace.get("window_s"),
        breakdown={k: out_trace[k] for k in ("device_ops", "idle_gaps") if k in out_trace},
    )


def hps_of(run):
    from perfbench.cfg import Cfg

    return Cfg({k: dict(run.config[k]) for k in ("train", "data", "model")})
