"""Benchmark: the PyTorch/CUDA port's flagship-model performance on one card
(the port's counterpart of bench.py).

    python3 bench_torch.py [--device cuda|cpu] [--config configs/config_cje.yaml]

Prints ONE JSON line with every key of bench.py's line. Headline metric =
TRUE-audio synthesis real-time factor (the audio seconds the duration
predictor asked for, not the padded frame budget), batch 1, 64 symbols,
400 frames. vs_baseline = rtf / 20, the ratio bench.py states against
BASELINE.md's 20x real time (a record of the JAX package on a TPU; it sets
no target for the port and is kept so the two lines compare key for key).

Extra keys carried in the same line:
  inference_rtf_padded     decoder-work RTF at the padded frame budget
  inference_rtf_pipelined  the same requests issued back to back, one
                           synchronize at the end
  batched_rtf[_pipelined]  true-audio RTF at batch 8 (multi-speaker CJE)
  frontend_g2p_ms          host text frontend (clean_text) per sentence
  engine_rtf, engine_p50_ms, engine_p95_ms, engine_batcher_rtf
                           TTSEngine (g2p -> bucket -> synthesis) on 22
                           sequential requests, then 44 through a
                           DynamicBatcher(max_batch=8, max_wait_ms=5.0)
  train_steps_per_sec      the GAN train step (training/step.py) at batch
                           32 x 400 frames x 128 symbols under the config's
                           bf16 policy, flagship Avocodo discriminator
  train_audio_sec_per_sec  seconds of audio those steps train per second
  train_flops_per_step     utils/profiling.py::step_flops of one more step
  train_mfu                flops x steps/s / the card's dense bf16 peak
                           (null where the card has no peak in the table)
  train_hbm_bytes          torch.cuda.max_memory_allocated over the timed
                           steps (null on the CPU)
  device                   the card's name and power limit (nvidia-smi)

Timing is the host clock around work that ends in a synchronize (or a host
read that waits for it). The weights are random from torch.manual_seed(0),
the inputs from numpy's default_rng(0). VITS_BENCH_SKIP_ENGINE=1 and
VITS_BENCH_SKIP_TRAIN=1 leave those parts out. A line on stderr names the
text frontend's backends; the last stderr line is a JSON object with the
train steps run and the MAS kernels' launch counts. Without a card and
without --device cpu the script exits non-zero before it builds a model.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
DEFAULT_CONFIG = os.path.join(ROOT, "configs", "config_cje.yaml")

# realistic mixed-CJE serving workload: tagged text through the serving path
# (g2p, text-bucket selection, frame-budget escalation, synthesis); the
# sentences span the 128 and 256 text buckets and the 512/1000 frame buckets
_ENGINE_SENTS = [
    ("[ZH]今天天气很好,我们一起去公园散步吧。[ZH]", 0),
    ("[JA]今日はいい天気ですね。散歩に行きましょう。[JA]", 2),
    ("[JA]明日の会議は午後三時からです。[JA]", 3),
    ("[EN]The weather is lovely today, let's take a walk in the park.[EN]", 4),
    ("[EN]Could you tell me how to get to the nearest station?[EN]", 0),
    ("[ZH]科技的发展改变了我们的生活方式。[ZH]", 1),
    ("[JA]音声合成の品質は年々良くなっています。[JA]", 2),
    ("[EN]Speech synthesis quality improves every single year.[EN]", 3),
    ("[ZH]祝你生日快乐,万事如意![ZH]", 4),
    ("[EN]Thank you very much for your help yesterday.[EN]", 0),
    ("[JA]駅までの道を教えてください。[JA]", 1),
]
_G2P_SENTS = [
    "[ZH]今天天气很好,我们一起去公园散步吧。[ZH]",
    "[JA]今日はいい天気ですね。散歩に行きましょう。[JA]",
    "[EN]The weather is lovely today, let's take a walk.[EN]",
]


def bench_device(device: str, script: str) -> torch.device:
    """The device a benchmark runs on; exits non-zero, naming the missing
    card, where it is a card and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{script}: no CUDA card (torch.cuda.is_available() is false); "
                 "pass --device cpu to run on the CPU")
    return dev


def device_label(dev: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    from vits_torch.utils.profiling import card_name

    return card_name() if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def report_launches(script: str, train_steps: int) -> None:
    """The last stderr line: train steps run and the hand-written kernels'
    launches."""
    from vits_torch.ops import kernel_launches

    print(json.dumps({"script": script, "train_steps": train_steps,
                      "launches": kernel_launches()}), file=sys.stderr)


def frontend_note(script: str) -> None:
    """A stderr line naming the text frontend's optional backends."""
    have = {m: importlib.util.find_spec(m) is not None for m in ("jieba", "pyopenjtalk")}
    print(f"{script}: text frontend: " + ", ".join(
        f"{m} {'present' if ok else 'absent (pure-Python fallback)'}" for m, ok in have.items()),
        file=sys.stderr)


def train_batch(rng, hps, b: int, tx: int, ty: int, dev: torch.device) -> dict:
    """bench.py's synthetic train batch, drawn in its order from ``rng``, in
    the JAX layout ``train_step`` takes (spec [B, T_y, F], ying [B, T_y, M],
    wav [B, T_y * hop, 1])."""
    from vits_torch.text.symbols import symbols

    hop = hps.data.hop_length
    draws = {
        "x": rng.integers(1, len(symbols), (b, tx)),
        "t": rng.integers(0, 6, (b, tx)),
        "x_lengths": np.asarray([tx] * b),
        "spec": np.abs(rng.standard_normal((b, ty, hps.data.filter_length // 2 + 1)))
        .astype(np.float32),
        "spec_lengths": np.asarray([ty] * b),
        "ying": rng.uniform(0, 1, (b, ty, hps.data.midis)).astype(np.float32),
        "wav": (rng.standard_normal((b, ty * hop, 1)) * 0.1).astype(np.float32),
        "sid": rng.integers(0, 5, (b,)),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in draws.items()}


def build_train_state(hps, dev: torch.device, bf16: bool):
    """Generator and the config's discriminator (flagship for config_cje)
    from torch.manual_seed(0), with their optimizers."""
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.training.step import create_train_state
    from vits_torch.training.train import build_discriminator

    torch.manual_seed(0)
    model = build_synthesizer(hps, device=dev, bf16=bf16)
    disc = build_discriminator(hps, bf16, dev)
    return create_train_state(model, disc, hps, steps_per_epoch=100)


def _bench_infer(model, b, tx, max_frames, sr, hop, n_iter=10):
    """(true-audio RTF, padded RTF, pipelined true-audio RTF) of
    ``SynthesizerTrn.infer`` at batch ``b``."""
    from vits_torch.text.symbols import symbols

    dev = model.device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, len(symbols), (b, tx))).to(dev)
    t = torch.from_numpy(rng.integers(0, 6, (b, tx))).to(dev)
    x_lengths = torch.full((b,), tx, device=dev)
    sid = torch.from_numpy(rng.integers(0, 5, (b,))).to(dev)

    def synthesize(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return model.infer(x, t, x_lengths, sid, generator=gen, noise_scale=0.667,
                           noise_scale_w=0.8, max_frames=max_frames)

    model.eval()
    with torch.inference_mode():
        synthesize(2)
        sync(dev)
        true_frames = 0
        start = time.perf_counter()
        for i in range(n_iter):
            _, _, yl = synthesize(i)
            # a host read of the lengths waits for this call's duration
            # predictor and everything queued before it...
            true_frames += int(yl.sum())
        sync(dev)  # ...but not its decoder: drain it before stopping
        elapsed = time.perf_counter() - start
        padded_sec = b * max_frames * hop / sr * n_iter
        true_sec = true_frames * hop / sr

        # pipelined: the lengths stay on the device, one synchronize at the end
        yls = []
        start2 = time.perf_counter()
        for i in range(n_iter):
            _, _, yl = synthesize(i)
            yls.append(yl)
        sync(dev)
        elapsed2 = time.perf_counter() - start2
        true_sec2 = sum(int(v.sum()) for v in yls) * hop / sr
    return true_sec / elapsed, padded_sec / elapsed, true_sec2 / elapsed2


def _bench_engine(config, dev):
    """End-to-end serving numbers through TTSEngine + DynamicBatcher:
    (engine_rtf, p50_ms, p95_ms, batcher_rtf).

      engine_rtf  - true-audio seconds per wall second, sequential requests
                    through TTSEngine.synthesize (g2p -> bucket -> synth)
      p50/p95_ms  - per-request latency percentiles of that loop
      batcher_rtf - true-audio throughput of 44 concurrent requests through
                    DynamicBatcher (max_batch 8)
    """
    from vits_torch.serve.batcher import DynamicBatcher
    from vits_torch.serve.engine import TTSEngine

    torch.manual_seed(0)
    engine = TTSEngine(config, None, max_frames=1000, device=dev)
    # every (text-bucket, frame-bucket) shape once, the batch path included
    for i, (s, spk) in enumerate(_ENGINE_SENTS):
        engine.synthesize(s, spk, seed=i)
    engine.synthesize_batch(
        [dict(text=s, speaker_id=spk, seed=i) for i, (s, spk) in enumerate(_ENGINE_SENTS)]
    )

    lat = []
    audio_sec = 0.0
    for i, (s, spk) in enumerate(_ENGINE_SENTS * 2):
        t0 = time.perf_counter()
        _, (sr, wav) = engine.synthesize(s, spk, seed=100 + i)  # ends in a host copy
        lat.append(time.perf_counter() - t0)
        audio_sec += len(wav) / sr
    engine_rtf = audio_sec / sum(lat)
    p50, p95 = np.percentile(lat, [50, 95])

    batcher = DynamicBatcher(engine, max_batch=8, max_wait_ms=5.0)
    reqs = [(s, spk) for s, spk in _ENGINE_SENTS * 4]
    # the exact workload once untimed: the batcher's worker thread pays its
    # first-call costs, and the timed loop's batch shapes have all been run
    for f in [batcher.submit(s, spk, seed=200 + i) for i, (s, spk) in enumerate(reqs)]:
        f.result()
    t0 = time.perf_counter()
    futs = [batcher.submit(s, spk, seed=200 + i) for i, (s, spk) in enumerate(reqs)]
    audio2 = sum(len(f.result()[1]) / engine.sampling_rate for f in futs)
    batcher_rtf = audio2 / (time.perf_counter() - t0)
    batcher.close()
    return engine_rtf, p50 * 1e3, p95 * 1e3, batcher_rtf


def _bench_train(hps, dev, n_iter=30, batch_size=32):
    """(steps/s, MFU or None, FLOPs a step, peak bytes or None, steps run):
    one warm-up step, ``n_iter`` timed ones, then one more counted by
    ``step_flops``. Batch 32 is bench.py's training point."""
    from vits_torch.training.step import train_step
    from vits_torch.utils.profiling import peak_bf16_flops, step_flops

    bf16 = bool(hps.train.get("bf16_run", False))
    state = build_train_state(hps, dev, bf16)
    batch = train_batch(np.random.default_rng(0), hps, batch_size, 128, 400, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        return train_step(state, batch, hps, generator=gen)

    metrics = step()
    float(metrics["loss/g/total"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    for _ in range(n_iter):
        metrics = step()
    sync(dev)
    elapsed = time.perf_counter() - start
    hbm_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    steps_per_sec = n_iter / elapsed
    flops = step_flops(step)
    peak = peak_bf16_flops(device_label(dev))
    mfu = flops * steps_per_sec / peak if peak and flops else None
    return steps_per_sec, mfu, flops, hbm_bytes, state.step


def bench_line(config, dev, infer_iters=10, train_iters=30, train_batch_size=32) -> dict:
    """Runs every part and returns bench.py's line (the sizes of the JAX
    script unless given)."""
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.text.cleaners import clean_text

    hps = load_hparams(config)
    torch.manual_seed(0)
    model = build_synthesizer(hps, device=dev)
    sr, hop = hps.data.sampling_rate, hps.data.hop_length

    rtf_true, rtf_padded, rtf_pipe = _bench_infer(model, 1, 64, 400, sr, hop, infer_iters)
    batched_true, _, batched_pipe = _bench_infer(model, 8, 64, 400, sr, hop, infer_iters)
    del model

    # host-side text frontend (g2p) latency, reported apart from the RTFs
    frontend_note("bench_torch.py")
    for s in _G2P_SENTS:
        clean_text(s)  # warm caches outside the timed loop
    t0 = time.perf_counter()
    n_g2p = 10
    for _ in range(n_g2p):
        for s in _G2P_SENTS:
            clean_text(s)
    g2p_ms = (time.perf_counter() - t0) / (n_g2p * len(_G2P_SENTS)) * 1e3

    out = {
        "metric": "inference_rtf",
        "value": rtf_true,
        "unit": "x_realtime_true_audio",
        "vs_baseline": rtf_true / 20.0,
        "inference_rtf_padded": rtf_padded,
        "inference_rtf_pipelined": rtf_pipe,
        "batched_rtf": batched_true,
        "batched_rtf_pipelined": batched_pipe,
        "frontend_g2p_ms": g2p_ms,
        "device": device_label(dev),
    }
    if not os.environ.get("VITS_BENCH_SKIP_ENGINE"):
        engine_rtf, p50_ms, p95_ms, batcher_rtf = _bench_engine(config, dev)
        out["engine_rtf"] = engine_rtf
        out["engine_p50_ms"] = p50_ms
        out["engine_p95_ms"] = p95_ms
        out["engine_batcher_rtf"] = batcher_rtf
    steps = 0
    if not os.environ.get("VITS_BENCH_SKIP_TRAIN"):
        steps_per_sec, mfu, flops, hbm, steps = _bench_train(hps, dev, train_iters,
                                                              train_batch_size)
        out["train_steps_per_sec"] = steps_per_sec
        out["train_batch_size"] = train_batch_size
        out["train_audio_sec_per_sec"] = steps_per_sec * train_batch_size * 400 * hop / sr
        out["train_mfu"] = mfu
        out["train_flops_per_step"] = flops
        out["train_hbm_bytes"] = hbm
    report_launches("bench_torch.py", steps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    args = ap.parse_args(argv)
    dev = bench_device(args.device, "bench_torch.py")
    print(json.dumps(bench_line(args.config, dev)))


if __name__ == "__main__":
    main()
