"""Driver of the long-form cell: ``TTSEngine.synthesize`` from one client in
a closed loop (the next paragraph is sent when the last one's audio is on
the host), over the engine at its defaults with the benchmark's weights and
noise (as ``serve_open_loop``). Every paragraph holds more ids than the
largest text bucket, so the engine splits it at phrase boundaries and runs
each piece at batch 1 with its frame-budget escalation; the batcher is not
on this path.

Set-up builds the engine, loads the weights and synthesizes every paragraph
of the mix's bank once. The window sends paragraphs, in an order permuted by
the seed, until ``--seconds`` have passed.

End to end: ``synth_audio_s_per_s``, the seconds of audio of the paragraphs
completed in the window over the window's wall time.

Traced (``--trace 1``): spans around ``engine.get_phoneme`` (g2p) and
``engine.model.infer`` (calls) during the window; then a profiled stretch of
``traced_requests`` more paragraphs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import checks, device as devmod, randomness, tracing, traffic
from perfbench.drivers.serve_open_loop import build_engine, hps_of, record_ids
from perfbench.harness import Outcome
from perfbench.reference import serve as ref_serve


def paragraphs(tr) -> list[str]:
    return traffic.paragraph_bank(tr, lambda text: len(ref_serve.phonemes(text)[0]))


def run(run, bf16: bool = False):
    dev, tr = run.device, run.traffic
    engine = build_engine(run, bf16)
    ids: dict[str, np.ndarray] = {}
    record_ids(engine, ids)
    bank = paragraphs(tr)
    for i, text in enumerate(bank):
        engine.synthesize(text, 0, randomness.subseed(run.seed, "warm", i) & 0xFFFFFFFF)
    devmod.sync(dev)

    spans = tracing.Spans()
    undo = []
    if run.trace:
        undo.append(tracing.wrap(engine, "get_phoneme", "g2p", spans))
        undo.append(tracing.wrap(engine.model, "infer", "infer", spans))
    devmod.reset_peak(dev)

    def request(k: int) -> dict:
        order = traffic.closed_loop_order(len(bank), run.seed, k // len(bank))
        return {"text": bank[order[k % len(bank)]], "speaker_id": k % int(tr.speakers),
                "seed": randomness.subseed(run.seed, "request", k) & 0xFFFFFFFF}

    # -- the window --------------------------------------------------------
    run.window_opens()
    sent, audio = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        r = request(len(sent))
        sent.append(r)
        _, (sr, wav) = engine.synthesize(r["text"], r["speaker_id"], r["seed"])
        audio.append(wav)
    window_s = time.perf_counter() - t0
    layer = {"requests": len(sent), "window_s": window_s, "infer_calls": spans.count("infer"),
             "g2p_s": spans.total("g2p"), "g2p_calls": spans.count("g2p")}
    memory_peak = devmod.peak_bytes(dev)

    out_trace = {}
    if run.trace and dev.type == "cuda":
        def traced():
            for j in range(int(tr.traced_requests)):
                r = request(len(sent) + j)
                engine.synthesize(r["text"], r["speaker_id"], r["seed"])

        out_trace = tracing.profile(traced)
    layer["trace"] = out_trace
    for u in undo:
        u()
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------------
    rng = np.random.default_rng(randomness.subseed(run.seed, "sample"))
    pick = set(rng.choice(len(sent), size=min(int(tr.sample), len(sent)), replace=False).tolist())
    pick.add(max(range(len(sent)), key=lambda i: len(audio[i])))
    records = [dict(sent[i], audio=audio[i], ids=ids.get(sent[i]["text"])) for i in sorted(pick)]
    nums = checks.serve_numbers(run, hps_of(run), records,
                                lambda seed, shapes: randomness.serve_noise(seed, shapes, dev))
    seconds = sum(len(a) for a in audio) / sr
    return Outcome(
        e2e={"synth_audio_s_per_s": seconds / window_s}, attempted=len(sent), failed=0,
        checks=checks.serve_checks(nums, run.limits), layer=layer,
        memory_peak_bytes=memory_peak,
        busy_s=out_trace.get("busy_s"), window_s=out_trace.get("window_s"),
        breakdown={k: out_trace[k] for k in ("device_ops", "idle_gaps") if k in out_trace},
    )
