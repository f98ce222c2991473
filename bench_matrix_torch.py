"""Benchmark matrix of the PyTorch/CUDA port (the port's counterpart of
bench_matrix.py), one card:

  1. single-sentence EN inference (text -> wav through the full frontend)
  2. multi-speaker CJE inference with speaker embedding
  3. batched inference
  4. the training step (MAS + KL/mel/duration + Avocodo GAN), f32,
     B=16 x 400 frames
  5. serving request latency (TTSEngine.synthesize)
  6. dynamic-batching throughput (TTSEngine.synthesize_batch of 8)

    python3 bench_matrix_torch.py [--device cuda|cpu] [--config configs/config_cje.yaml]

Prints one JSON line per scenario, with bench_matrix.py's metric names and
keys. Random weights from torch.manual_seed(0); each timing is the host
clock over n calls after one warm-up call, ended by a synchronize. The
first stderr line names the device; the last is a JSON object with the
train steps run and the MAS kernels' launch counts. Without a card and
without --device cpu the script exits non-zero before it builds a model.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bench_torch import (DEFAULT_CONFIG, bench_device, build_train_state, device_label,
                         report_launches, sync, train_batch)

EN_TEXT = "[EN]the quick brown fox jumps over the lazy dog[EN]"


def scenario_lines(config, dev, n=15, train_batch_size=16):
    """Yields the six scenarios' lines (bench_matrix.py's sizes and ``n``
    timed calls each unless given), then reports the kernel launches."""
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops.commons import intersperse_with_language_id
    from vits_torch.serve.engine import TTSEngine
    from vits_torch.text import cleaned_text_to_sequence
    from vits_torch.text.cleaners import clean_text
    from vits_torch.text.symbols import symbols
    from vits_torch.training.step import train_step

    hps = load_hparams(config)
    torch.manual_seed(0)
    model = build_synthesizer(hps, device=dev).eval()
    hop, sr = hps.data.hop_length, hps.data.sampling_rate

    def timed(fn, n=n):
        fn()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(dev)
        return (time.perf_counter() - t0) / n

    def prep_text(tagged, tx):
        cleaned, lang = clean_text(tagged)
        seq, lang = intersperse_with_language_id(cleaned_text_to_sequence(cleaned), lang, 0)
        x = np.zeros((1, tx), np.int64)
        t = np.zeros((1, tx), np.int64)
        m = min(len(seq), tx)
        x[0, :m] = seq[:m]
        t[0, :m] = lang[:m]
        return (torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev),
                torch.tensor([m], device=dev))

    def synthesizer(x, t, xl, sid, seed):
        def syn():
            with torch.inference_mode():
                gen = torch.Generator(device=dev).manual_seed(seed)
                return model.infer(x, t, xl, sid, generator=gen, noise_scale=0.667,
                                   noise_scale_w=0.8, max_frames=400)
        return syn

    # ---- scenario 1: EN sentence ---------------------------------------
    x, t, xl = prep_text(EN_TEXT, 128)
    dt = timed(synthesizer(x, t, xl, torch.tensor([0], device=dev), 2))
    yield {"metric": "en_sentence_rtf", "value": 400 * hop / sr / dt,
           "unit": "x_realtime", "ms_per_call": dt * 1000}

    # ---- scenario 2: multi-speaker CJE ---------------------------------
    x2, t2, _ = prep_text("[P]ni3#hao3[P] [EN]hello[EN]", 128)
    b = 4
    # bench_matrix.py's lengths: the non-blank ids (blanks are id 0)
    xls = torch.full((b,), int((x2 != 0).sum()), device=dev)
    dt = timed(synthesizer(x2.repeat(b, 1), t2.repeat(b, 1), xls,
                           torch.tensor([0, 1, 2, 3], device=dev), 3))
    yield {"metric": "cje_multispeaker_rtf", "value": b * 400 * hop / sr / dt,
           "unit": "x_realtime", "batch": b, "ms_per_call": dt * 1000}

    # ---- scenario 3: batched inference ---------------------------------
    b = 8
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.integers(1, len(symbols), (b, 96))).to(dev)
    tb = torch.from_numpy(rng.integers(0, 6, (b, 96))).to(dev)
    sidb = torch.from_numpy(rng.integers(0, 5, (b,))).to(dev)
    dt = timed(synthesizer(xb, tb, torch.full((b,), 96, device=dev), sidb, 4))
    yield {"metric": "batched_inference_rtf", "value": b * 400 * hop / sr / dt,
           "unit": "x_realtime", "batch": b, "ms_per_call": dt * 1000}
    del model

    # ---- scenario 4: training step (f32) ---------------------------------
    bt, ty = train_batch_size, 400
    state = build_train_state(hps, dev, bf16=False)
    batch = train_batch(rng, hps, bt, 128, ty, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    dt = timed(lambda: train_step(state, batch, hps, generator=gen))
    train_steps = state.step
    del state, batch
    yield {"metric": "train_step_time", "value": dt * 1000, "unit": "ms", "batch": bt,
           "frames": ty, "steps_per_sec": 1 / dt}

    # ---- scenario 5: serving request latency (engine level) ------------
    torch.manual_seed(0)
    eng = TTSEngine(config, device=dev)  # random-init weights
    eng.synthesize(EN_TEXT, speaker_id=0, seed=0)  # warm-up
    t0 = time.perf_counter()
    n_req = 5
    total_audio = 0.0
    for i in range(n_req):
        _, (sr_out, audio) = eng.synthesize(EN_TEXT, speaker_id=0, seed=i)
        total_audio += len(audio) / sr_out
    dt = (time.perf_counter() - t0) / n_req
    # host-side g2p time, reported separately (outside every RTF above)
    g2p_texts = [
        EN_TEXT,
        "[ZH]今天天气真不错，我们一起去公园散步吧。[ZH]",
        "[JA]今日はいい天気ですね。散歩に行きましょう。[JA]",
    ]
    for s in g2p_texts:
        eng.get_phoneme(s)
    t1 = time.perf_counter()
    n_g2p = 20
    for _ in range(n_g2p):
        for s in g2p_texts:
            eng.get_phoneme(s)
    g2p_ms = (time.perf_counter() - t1) / (n_g2p * len(g2p_texts)) * 1000
    yield {"metric": "serving_request_latency", "value": dt * 1000, "unit": "ms",
           "audio_s_per_request": total_audio / n_req, "rtf": total_audio / n_req / dt,
           "g2p_ms_per_sentence": g2p_ms}

    # ---- scenario 6: dynamic-batching throughput (engine level) --------
    reqs8 = [{"text": EN_TEXT, "speaker_id": i % 3, "seed": i} for i in range(8)]
    eng.synthesize_batch(reqs8)  # warm-up
    t0 = time.perf_counter()
    n_rounds = 5
    total_audio_b = 0.0
    for r in range(n_rounds):
        outs = eng.synthesize_batch([{**q, "seed": q["seed"] + r} for q in reqs8])
        total_audio_b += sum(len(a) for a in outs) / eng.sampling_rate
    dt_b = time.perf_counter() - t0
    yield {"metric": "serving_batched_throughput", "value": n_rounds * len(reqs8) / dt_b,
           "unit": "requests/s", "batch": len(reqs8), "rtf": total_audio_b / dt_b,
           "vs_sequential_rtf": (total_audio_b / dt_b) / max(total_audio / n_req / dt, 1e-9)}
    report_launches("bench_matrix_torch.py", train_steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    args = ap.parse_args(argv)
    dev = bench_device(args.device, "bench_matrix_torch.py")
    print(f"bench_matrix_torch.py: {device_label(dev)}", file=sys.stderr)
    for line in scenario_lines(args.config, dev):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
