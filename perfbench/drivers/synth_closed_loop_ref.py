"""Driver of a long-form cell whose configuration names its own plain
reference (the key ``reference``, ``"<module>:<function>"``, a builder
``build(hps, device)`` of a model that ``reference/serve.py::synth_piece``
serves): ``synth_closed_loop`` otherwise. ``TTSEngine.synthesize`` from one
client in a closed loop over the engine at its defaults, with the
benchmark's weights and noise; every paragraph is split at phrase boundaries
and its pieces run at batch 1.

Set-up builds the engine, loads the weights and synthesizes every paragraph
of the mix's bank once. The window sends paragraphs, in an order permuted by
the seed, until ``--seconds`` have passed.

End to end: ``synth_audio_s_per_s``, the seconds of audio of the paragraphs
completed in the window over the window's wall time.

Traced (``--trace 1``): spans around ``engine.get_phoneme`` (g2p) and
``engine.model.infer`` (calls) during the window; then two profiled
stretches. First one paragraph with the engine's CUDA graphs set aside
(``model.infer_graphs`` None, every launch eager), under the spans
``infer_eager`` (``model.infer``) and ``decode`` (the decoder's
``forward``); the program's counters are then cleared, so that they count
the second stretch alone: ``traced_requests`` more paragraphs with the
graphs, under the window's spans.

Correctness: as ``synth_closed_loop`` (``checks.compare_request`` on a
seeded sample of the window's paragraphs and the longest), against the
configuration's reference.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from perfbench import checks, device as devmod, randomness, tracing, traffic, weights
from perfbench.drivers.serve_open_loop import build_engine, hps_of, record_ids
from perfbench.drivers.synth_closed_loop import paragraphs
from perfbench.harness import Outcome
from perfbench.reference import precision
from perfbench.reference import serve as ref_serve
from vits_torch.utils import profiling


def reference_builder(config):
    module, name = str(config.reference).split(":")
    return getattr(importlib.import_module(module), name)


def serve_numbers(run, hps, records: list[dict], noise_fn) -> dict:
    """``checks.serve_numbers`` against the configuration's reference."""
    dev = run.device
    lim = run.limits
    hop = hps.data.hop_length
    with precision.exact():
        g = reference_builder(run.config)(hps, dev)
        shapes = {f"g.{k}": v for k, v in weights.shapes_of(g).items()}
        weights.load(g, {k[2:]: v for k, v in weights.make(shapes, run.seed, dev).items()})
        g.eval()
        agg = {"ids_off": 0, "frames_off": 0.0, "compared": 0, "samples": 0}
        errors, ratios = [], []
        for r in records:
            seq, lang = ref_serve.phonemes(r["text"], bool(hps.data.add_blank))

            def synth():
                return [ref_serve.synth_piece(g, s, la, r["speaker_id"], noise_fn,
                                              (r["seed"] + i) & 0xFFFFFFFF,
                                              int(run.traffic.max_frames))
                        for i, (s, la) in enumerate(ref_serve.split_segments(seq, lang))]

            pieces = synth()
            with precision.defaults():
                yardstick = np.concatenate([p["audio"] for p in synth()])
            one = checks.compare_request(pieces, r["audio"], r.get("ids"), seq, hop, lim)
            base = checks.compare_request(pieces, yardstick, seq, seq, hop, lim)
            agg["frames_off"] = max(agg["frames_off"], one["frames_off"])
            for k in ("ids_off", "compared", "samples"):
                agg[k] += one[k]
            if one["norm"] > 0:
                err, unit = (one["diff"] / one["norm"]) ** 0.5, (base["diff"] / one["norm"]) ** 0.5
                errors.append(err)
                ratios.append(err / max(unit, checks.ERR_FLOOR))
            elif one["diff"] != 0:
                ratios.append(float("nan"))
    del g
    print(f"perfbench: the audio compared is {agg['compared'] / max(agg['samples'], 1):.4f} of "
          f"the sample's ({len(records)} requests)", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ratio = max(ratios) if ratios and all(e == e for e in ratios) else float("nan")
    print(f"perfbench: each request's audio error {[float(f'{e:.4g}') for e in errors]}, "
          f"in the yardstick's units {[float(f'{e:.4g}') for e in ratios]}", file=sys.stderr)
    return {"ids_off": float(agg["ids_off"]), "frames_off": float(agg["frames_off"]),
            "audio_ratio": ratio}


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

    def send(r: dict):
        return engine.synthesize(r["text"], r["speaker_id"], r["seed"])

    # -- the window --------------------------------------------------------
    run.window_opens()
    sent, audio = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        r = request(len(sent))
        sent.append(r)
        _, (sr, wav) = send(r)
        audio.append(wav)
    window_s = time.perf_counter() - t0
    layer = {"requests": len(sent), "window_s": window_s, "infer_calls": spans.count("infer"),
             "g2p_s": spans.total("g2p"), "g2p_calls": spans.count("g2p"),
             "traced_requests": int(tr.traced_requests)}
    memory_peak = devmod.peak_bytes(dev)

    out_trace, eager_trace = {}, {}
    if run.trace and dev.type == "cuda":
        n = len(sent)
        graphs, engine.model.infer_graphs = engine.model.infer_graphs, None
        eager = [tracing.wrap(engine.model, "infer", "infer_eager", spans),
                 tracing.wrap(engine.model.waveform_decoder, "forward", "decode", spans)]
        eager_trace = tracing.profile(lambda: send(request(n)))
        for u in reversed(eager):
            u()
        engine.model.infer_graphs = graphs
        profiling.reset()
        out_trace = tracing.profile(
            lambda: [send(request(n + 1 + j)) for j in range(int(tr.traced_requests))])
    layer["trace"], layer["eager_trace"] = out_trace, eager_trace
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
    nums = serve_numbers(run, hps_of(run), records,
                         lambda seed, shapes: randomness.serve_noise(seed, shapes, dev))
    seconds = sum(len(a) for a in audio) / sr
    return Outcome(
        e2e={"synth_audio_s_per_s": seconds / window_s}, attempted=len(sent), failed=0,
        checks=checks.serve_checks(nums, run.limits), layer=layer,
        memory_peak_bytes=memory_peak,
        busy_s=out_trace.get("busy_s"), window_s=out_trace.get("window_s"),
        breakdown={k: out_trace[k] for k in ("device_ops", "idle_gaps") if k in out_trace},
    )
