#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (vits_torch) runs on one NVIDIA
card: builds the CUDA kernels from vits_torch/csrc, holds each against its
plain PyTorch version, drives the generator's training forward and serving
path at the full width and depth of configs/config_cje.yaml with random
weights from a seed, and checks the card against the CPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the script with a non-zero exit; nothing falls back
to the CPU):
  1. build     nvcc for sm_90a, one process per source, all started together
  2. kernels   the fused MAS kernel (the main path's) and the first port's
               forward + backtrack pair against the plain version, exact, at
               the test shapes, the edge cases (t_y < t_x, t_x = 1,
               zero-length items, t_y == t_x with partial lengths), the
               main-path shape and the largest bucket (64, 1500, 384); the
               fused kernel and the pair timed in turns (pair, fused, fused,
               pair) with their bounds
  3. forward   SynthesizerTrn.forward, B=16 x T_y=400, text 129-191 ids,
               features made by the port's spectrogram and Yingram from a
               synthetic waveform; it must launch mas_fused once and the
               pair never
  4. infer     SynthesizerTrn.infer at batch 1 and 8, max_frames=1000
  5. train     training/step.py::train_step at full width: the CJE generator
               and the flagship Avocodo discriminator, B=16 x 400 frames with
               their waveform, segment 8192, once under the config's bf16
               policy and once in f32: 2 warm-up steps, then 10 timed ones;
               losses at the first and last step, parameters moved, peak
               memory, and exactly one mas_fused launch a step
  6. card-cpu  the tiny test configuration's forward and one train step
               (probe discriminator) on the card and on the CPU with the same
               weights, noise and PhaseAug rotations, TF32 off, cuDNN
               deterministic, dropout off: every metric, gradient and updated
               parameter held to the CPU's; attn and ids_slice exact

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Every number printed carries the card's
name and power limit. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_B, MAIN_T_Y, MAIN_T_X = 16, 400, 191
CHECK_CASES = [(4, 37, 11), (2, 64, 48), (8, 150, 130), (3, 40, 40), (32, 800, 384),
               (64, 1500, 384)]
# (B, T_y, T_x, t_ys, t_xs): t_y < t_x, t_x = 1, zero-length items, square
# with partial lengths
EDGE_CASES = [
    (3, 20, 30, [12, 20, 5], [30, 25, 17]),
    (3, 40, 1, [40, 7, 1], [1, 1, 1]),
    (4, 30, 12, [30, 0, 18, 0], [0, 12, 9, 0]),
    (3, 40, 40, [40, 33, 25], [40, 33, 17]),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of fn() over iters launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=10) -> tuple[float, float, float]:
    """(median, min, max) wall ms of fn() + synchronize over iters runs,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times), max(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mas_case(b, t_y, t_x, seed, t_ys=None, t_xs=None):
    """Random scores with lengths t_y >= t_x (drawn unless given), on the card."""
    rng = np.random.default_rng(seed)
    neg = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    if t_ys is None:
        t_xs = rng.integers(2, t_x + 1, size=b)
        t_ys = np.maximum(rng.integers(t_x, t_y + 1, size=b), t_xs)
    mask = (
        (np.arange(t_y)[None, :, None] < np.asarray(t_ys)[:, None, None])
        & (np.arange(t_x)[None, None, :] < np.asarray(t_xs)[:, None, None])
    ).astype(np.float32)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(neg).to(dev),
        torch.from_numpy(mask).to(dev),
        torch.as_tensor(np.asarray(t_ys), dtype=torch.int32, device=dev),
        torch.as_tensor(np.asarray(t_xs), dtype=torch.int32, device=dev),
    )


def check_mas(card: str, main_lengths) -> dict:
    """Phase 2: every MAS kernel against its plain version, exact; times."""
    from vits_torch.ops import mas, mas_cuda

    err = {"mas_fused": 0.0, "mas_forward": 0.0, "mas_backtrack": 0.0}
    # t_y == t_x is the diagonal case: full lengths force the identity path
    cases = [(b, ty, tx, *(([ty] * b, [tx] * b) if ty == tx else (None, None)))
             for b, ty, tx in CHECK_CASES]
    cases += EDGE_CASES
    cases.append((MAIN_B, MAIN_T_Y, MAIN_T_X, *main_lengths))
    for i, (b, t_y, t_x, t_ys, t_xs) in enumerate(cases):
        neg, mask, ty, tx = mas_case(b, t_y, t_x, 100 + i, t_ys, t_xs)
        ref = mas.maximum_path_torch(neg, mask)
        e_u = (mas_cuda.mas_fused(neg, mask) - ref).abs().max().item()
        full = mas.maximum_path(neg, mask)
        e_p = (full - ref).abs().max().item()
        dec_plain = mas.mas_decisions(neg, mask)
        dec = mas_cuda.mas_forward(neg, ty, tx)
        inside = mask.bool()
        e_f = (dec[inside].float() - dec_plain[inside].float()).abs().max().item()
        path = mas_cuda.mas_backtrack(dec_plain, ty, tx)
        e_b = (path - mas.mas_backtrack(dec_plain, ty, tx)).abs().max().item()
        torch.cuda.synchronize()
        if t_ys is not None and t_y == t_x and t_ys[0] == t_y and t_xs[0] == t_x \
                and not torch.equal(full[0].cpu(), torch.eye(t_y)):
            raise AssertionError("MAS: t_y == t_x must give the identity path")
        print(f"{card} | mas check B={b} T_y={t_y} T_x={t_x}: fused max|err|={e_u} "
              f"maximum_path max|err|={e_p} forward max|err|={e_f} backtrack max|err|={e_b}")
        if e_u or e_p or e_f or e_b:
            raise AssertionError("MAS kernel disagrees with the plain version")
        for k, e in (("mas_fused", max(e_u, e_p)), ("mas_forward", e_f), ("mas_backtrack", e_b)):
            err[k] = max(err[k], e)

    rows = {}
    shapes = (("main", cases[-1]), ("large", cases[4]), ("largest", cases[5]))
    for label, (b, t_y, t_x, t_ys, t_xs) in shapes:
        neg, mask, ty, tx = mas_case(b, t_y, t_x, 7, t_ys, t_xs)
        cells = float((ty.double() * tx.double()).sum())
        path_bytes = 4.0 * b * t_y * t_x

        def pair():
            return mas_cuda.mas_backtrack(mas_cuda.mas_forward(neg, ty, tx), ty, tx)

        def fused():
            return mas_cuda.mas_fused(neg, mask)

        turns = [cuda_ms(pair), cuda_ms(fused), cuda_ms(fused), cuda_ms(pair)]
        pair_ms, fused_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        dec = mas_cuda.mas_forward(neg, ty, tx)
        fw_ms = cuda_ms(lambda: mas_cuda.mas_forward(neg, ty, tx))
        bt_ms = cuda_ms(lambda: mas_cuda.mas_backtrack(dec, ty, tx))
        whole_ms = cuda_ms(lambda: mas.maximum_path(neg, mask))
        fw_plain = cuda_ms(lambda: mas.mas_decisions(neg, mask), iters=3, warmup=1)
        dec_plain = mas.mas_decisions(neg, mask)
        bt_plain = cuda_ms(lambda: mas.mas_backtrack(dec_plain, ty, tx), iters=3, warmup=1)
        fused_plain = cuda_ms(lambda: mas.maximum_path_torch(neg, mask), iters=3, warmup=1)
        # fused: read the scores inside the rectangles and the mask's first
        # column and row, write the whole f32 path; add, max and compare a cell
        fused_bound = bound_ms(4 * cells + 4.0 * b * (t_y + t_x) + path_bytes, 3 * cells)
        # forward: read the scores inside the rectangles (4 B), write one
        # decision byte each; add, max and compare a cell
        fw_bound = bound_ms(5 * cells, 3 * cells)
        # backtrack: one decision a row, write the whole f32 path
        bt_bound = bound_ms(float(ty.sum()) + path_bytes, float(ty.sum()))
        print(f"{card} | mas {label} B={b} T_y={t_y} T_x={t_x}: in turns pair {turns[0]:.4f}, "
              f"fused {turns[1]:.4f}, fused {turns[2]:.4f}, pair {turns[3]:.4f} ms; fused "
              f"{fused_ms:.4f} ms against pair {pair_ms:.4f} ms ({pair_ms / fused_ms:.2f}x), "
              f"bound {fused_bound[0]:.5f} ms by {fused_bound[1]} "
              f"({(4 * cells + 4.0 * b * (t_y + t_x) + path_bytes) / 1e6:.1f} MB), plain "
              f"{fused_plain:.3f} ms; maximum_path {whole_ms:.4f} ms; forward {fw_ms:.4f} ms "
              f"(plain {fw_plain:.3f} ms, bound {fw_bound[0]:.5f} ms by {fw_bound[1]}); backtrack "
              f"{bt_ms:.4f} ms (plain {bt_plain:.3f} ms, bound {bt_bound[0]:.5f} ms by {bt_bound[1]})")
        if fused_ms >= pair_ms:
            raise AssertionError(f"mas {label}: the fused kernel is not faster than the pair")
        rows[label] = dict(fused=(fused_ms, fused_plain, fused_bound), fw=(fw_ms, fw_plain, fw_bound),
                           bt=(bt_ms, bt_plain, bt_bound))
    print(f"{card} | mas note: the fused kernel's time is its serial chain of t_y DP row "
          f"steps and t_y walk steps on one warp an item, not bytes")
    return {"err": err, "main": rows["main"]}


def synthetic_batch(hps, rng, dev):
    """B=16 utterances of 300-400 frames with 129-191 symbols, their
    waveforms [B, 400 * hop, 1] and the linear spectrograms and yingrams the
    port computes from them on the card."""
    from vits_torch.ops.stft import spectrogram
    from vits_torch.ops.yin import Yingram
    from vits_torch.text.symbols import symbols

    d = hps.data
    hop = d.hop_length
    y_lengths = rng.integers(300, MAIN_T_Y + 1, size=MAIN_B)
    y_lengths[0] = MAIN_T_Y
    x_lengths = rng.integers(129, MAIN_T_X + 1, size=MAIN_B)
    x_lengths[0] = MAIN_T_X
    n = np.arange(MAIN_T_Y * hop)
    f0 = rng.uniform(90, 300, size=(MAIN_B, 1))
    wav = (0.4 * np.sin(2 * np.pi * f0 * n / d.sampling_rate)
           + 0.2 * np.sin(4 * np.pi * f0 * n / d.sampling_rate)
           + 0.02 * rng.standard_normal((MAIN_B, n.size)))
    wav *= n[None, :] < (y_lengths[:, None] * hop)
    wav = torch.from_numpy(wav.astype(np.float32)).to(dev)
    spec = spectrogram(wav, d.filter_length, hop, d.win_length)
    left = d.filter_length - hop
    right = left + (-wav.shape[1]) % hop + hop * (wav.shape[1] % hop == 0)
    yingram = Yingram(d.sampling_rate, hop, d.ying_window, d.tau_max, d.midi_start,
                      d.midi_end, d.octave_range)
    ying = yingram(torch.nn.functional.pad(wav, (left, right)))
    if spec.shape != (MAIN_B, MAIN_T_Y, d.filter_length // 2 + 1) or ying.shape != (
        MAIN_B, MAIN_T_Y, d.midis
    ):
        raise AssertionError(f"features: spec {tuple(spec.shape)}, yingram {tuple(ying.shape)}")
    x = torch.from_numpy(rng.integers(1, len(symbols), (MAIN_B, MAIN_T_X))).to(dev)
    t = torch.from_numpy(rng.integers(0, 6, (MAIN_B, MAIN_T_X))).to(dev)
    sid = torch.from_numpy(rng.integers(0, len(d.speakers), MAIN_B)).to(dev)
    return dict(
        x=x, t=t, x_lengths=torch.from_numpy(x_lengths).to(dev), y=spec,
        y_lengths=torch.from_numpy(y_lengths).to(dev), ying=ying, sid=sid, wav=wav[:, :, None],
    )


def check_forward(card, model, batch, gen, hps):
    """Phase 3: the full-width training forward (the main path)."""
    from vits_torch.ops import mas_cuda

    b = batch

    def run():
        return model(b["x"], b["t"], b["x_lengths"], b["y"], b["y_lengths"], b["ying"],
                     b["sid"], generator=gen)

    model.train()
    with torch.no_grad():
        for k in mas_cuda.launches:
            mas_cuda.launches[k] = 0
        out = run()
        torch.cuda.synchronize()
        launches = dict(mas_cuda.launches)
        ms = host_ms(run)
    print(f"{card} | forward launches on the main path: {launches}")
    if launches != {"mas_fused": 1, "mas_forward": 0, "mas_backtrack": 0}:
        raise AssertionError("the training forward must launch mas_fused once and the pair never")
    seg = hps.train.segment_size
    inter, two_b = hps.model.inter_channels, 2 * MAIN_B
    shapes = {
        "attn": (MAIN_B, MAIN_T_Y, MAIN_T_X), "z_p": (MAIN_B, MAIN_T_Y, inter),
        "m_p": (MAIN_B, MAIN_T_Y, inter), "l_length": (MAIN_B,), "ids_slice": (two_b,),
        "yin_hat_crop": (two_b, seg // hps.data.hop_length, hps.model.yin_scope),
    }
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"forward[{k}] has shape {tuple(out[k].shape)}, want {shape}")
    if [tuple(w.shape) for w in out["wav_hier"]] != [(two_b, seg // 4, 1), (two_b, seg // 2, 1), (two_b, seg, 1)]:
        raise AssertionError("wav_hier shapes")
    for k, v in out.items():
        for a in v if isinstance(v, list) else [v]:
            if a.is_floating_point() and not torch.isfinite(a).all():
                raise AssertionError(f"forward[{k}] is not finite")
    attn = out["attn"]
    if not torch.equal(attn.sum(dim=(1, 2)).long(), b["y_lengths"].long()):
        raise AssertionError("attn does not cover each frame once")
    if not torch.equal(attn.sum(dim=2)[:, :, None], out["z_mask"]):
        raise AssertionError("attn must give each valid frame exactly one symbol")
    print(f"{card} | forward B={MAIN_B} T_y={MAIN_T_Y} T_x={MAIN_T_X} full CJE width: "
          f"median {ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n=10; host clock, "
          f"synchronized, no_grad, train mode, TF32 convolutions as PyTorch defaults)")
    return launches, ms


def check_infer(card, model, hps, rng, gen):
    """Phase 4: serving at batch 1 and 8, max_frames=1000."""
    from vits_torch.ops import mas_cuda
    from vits_torch.text.symbols import symbols

    dev = model.device
    hop, sr = hps.data.hop_length, hps.data.sampling_rate
    model.eval()
    results = {}
    for bsz in (1, 8):
        t_x = MAIN_T_X
        x_lengths = np.full(bsz, t_x) if bsz == 1 else rng.integers(129, t_x + 1, size=bsz)
        x = torch.from_numpy(rng.integers(1, len(symbols), (bsz, t_x))).to(dev)
        t = torch.from_numpy(rng.integers(0, 6, (bsz, t_x))).to(dev)
        sid = torch.from_numpy(rng.integers(0, len(hps.data.speakers), bsz)).to(dev)
        xl = torch.from_numpy(x_lengths).to(dev)
        for k in mas_cuda.launches:
            mas_cuda.launches[k] = 0
        with torch.no_grad():
            wav, y_mask, y_lengths = model.infer(x, t, xl, sid, generator=gen, max_frames=1000)
            torch.cuda.synchronize()
            launches = dict(mas_cuda.launches)
            ms = host_ms(lambda: model.infer(x, t, xl, sid, generator=gen, max_frames=1000))
        if tuple(wav.shape) != (bsz, 1000 * hop, 1) or not torch.isfinite(wav).all():
            raise AssertionError(f"infer batch {bsz}: wav {tuple(wav.shape)} or not finite")
        audio_s = float(y_lengths.sum()) * hop / sr
        print(f"{card} | infer batch {bsz} max_frames=1000: median {ms[0]:.2f} ms "
              f"(min {ms[1]:.2f}, max {ms[2]:.2f}, n=10), {audio_s:.2f} s of audio "
              f"(sum of y_lengths), real-time factor {ms[0] / 1e3 / audio_s:.5f}; "
              f"MAS launches {launches}")
        results[bsz] = ms
    return results


def check_card_against_cpu(card, seed):
    """Phase 5: tiny configuration, same weights and noise, card vs CPU."""
    from vits_torch.models.synthesizer import SynthesizerTrn

    tiny = dict(
        num_chars=30, spec_channels=513, segment_size=2048, midi_start=-5, midi_end=75,
        octave_range=24, inter_channels=96, hidden_channels=96, filter_channels=128,
        n_heads=2, n_layers=1, kernel_size=3, p_dropout=0.0, resblock="1",
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
        upsample_rates=[8, 8, 2, 2], upsample_initial_channel=64,
        upsample_kernel_sizes=[16, 16, 4, 4], yin_channels=80, yin_start=15,
        yin_scope=50, yin_shift_range=15, n_speakers=3, gin_channels=16,
        posterior_layers=2, flow_n_flows=2, flow_wn_layers=1, dur_n_flows=1,
        yin_dec_layers=2,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(seed)
    cpu = SynthesizerTrn(**tiny, device="cpu").eval()
    gpu = SynthesizerTrn(**tiny, device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    b, t_x, t_y = 2, 11, 24
    inputs = [
        rng.integers(1, 30, (b, t_x)), rng.integers(0, 6, (b, t_x)), np.array([t_x, t_x - 3]),
        np.abs(rng.standard_normal((b, t_y, 513))).astype(np.float32),
        np.array([t_y, t_y - 5]), rng.uniform(0, 1, (b, t_y, 80)).astype(np.float32),
        np.array([0, 2]),
    ]
    noise = {
        "eps_spec": rng.standard_normal((b, t_y, 16)).astype(np.float32),
        "eps_yin": rng.standard_normal((b, t_y, 80)).astype(np.float32),
        "scope_shift": rng.integers(-15, 15, b).astype(np.int32),
        "e_q": rng.standard_normal((b, t_x, 2)).astype(np.float32),
        "slice_u": rng.uniform(0, 1, b).astype(np.float32),
    }
    with torch.no_grad():
        ref = cpu(*(torch.from_numpy(a) for a in inputs), noise=noise)
        out = gpu(*(torch.from_numpy(a).cuda() for a in inputs), noise=noise)
    # f32 on both; cuDNN and the CPU sum convolutions in other orders
    tol = dict(rtol=1e-4, atol=1e-4)
    worst = 0.0
    for k, r in ref.items():
        for ra, oa in zip(r if isinstance(r, list) else [r], out[k] if isinstance(r, list) else [out[k]]):
            oa = oa.cpu()
            if k in ("attn", "ids_slice", "scope_shift", "x_mask", "z_mask"):
                if not torch.equal(oa, ra):
                    raise AssertionError(f"card vs CPU: {k} differs")
                continue
            torch.testing.assert_close(oa, ra, **tol, msg=lambda m, k=k: f"card vs CPU {k}: {m}")
            worst = max(worst, (oa - ra).abs().max().item())
    print(f"{card} | card vs CPU, tiny config, TF32 off: attn exact, other keys max|err|="
          f"{worst:.3e} (tolerance rtol 1e-4, atol 1e-4)")


TRAIN_WARMUP, TRAIN_TIMED = 2, 10


def check_train(card, hps, batch, seed, bf16):
    """Phase 5: the full-width GAN train step (the main path), one precision."""
    from vits_torch.models.avocodo import AvocodoDiscriminator
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops import mas_cuda
    from vits_torch.training.step import create_train_state, train_step

    label = "bf16" if bf16 else "f32"
    torch.manual_seed(seed)
    model = build_synthesizer(hps, bf16=bf16)
    disc = AvocodoDiscriminator(bf16=bf16, segment_size=hps.train.segment_size)
    # the schedule's epoch length does not matter within 12 steps
    state = create_train_state(model, disc, hps, steps_per_epoch=100)
    start = [p.detach().clone() for m in (model, disc) for p in m.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = batch
    tb = dict(x=b["x"], t=b["t"], x_lengths=b["x_lengths"], spec=b["y"],
              spec_lengths=b["y_lengths"], ying=b["ying"], wav=b["wav"], sid=b["sid"])
    n = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first = [], None
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    for i in range(n):
        t0 = time.perf_counter()
        metrics = train_step(state, tb, hps, generator=gen)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = {k: v.item() for k, v in metrics.items()}
    launches = dict(mas_cuda.launches)
    last = {k: v.item() for k, v in metrics.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = [not torch.equal(a, p.detach())
             for a, p in zip(start, (p for m in (model, disc) for p in m.parameters()))]
    ms = (float(np.median(times)), min(times), max(times))
    print(f"{card} | train step {label} B={MAIN_B} T_y={MAIN_T_Y} T_x={MAIN_T_X} segment "
          f"{hps.train.segment_size}, CJE generator + flagship Avocodo: median {ms[0]:.2f} ms "
          f"(min {ms[1]:.2f}, max {ms[2]:.2f}, n={TRAIN_TIMED} after {TRAIN_WARMUP} warm-up "
          f"steps; host clock, synchronized; TF32 convolutions as PyTorch defaults); peak "
          f"memory {peak / 2**30:.2f} GiB; launches in {n} steps {launches}")
    for tag, m in (("first", first), ("last", last)):
        print(f"{card} | train step {label} {tag} step: "
              + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    print(f"{card} | train step {label}: {sum(moved)} of {len(moved)} parameter tensors moved")
    if launches != {"mas_fused": n, "mas_forward": 0, "mas_backtrack": 0}:
        raise AssertionError(f"train step {label}: mas_fused must launch once a step")
    if not all(np.isfinite(v) for m in (first, last) for v in m.values()):
        raise AssertionError(f"train step {label}: a loss is not finite")
    if not all(moved):
        raise AssertionError(f"train step {label}: {len(moved) - sum(moved)} tensors never moved")
    del state, model, disc, start
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches, "launches_per_step": launches["mas_fused"] / n,
            "peak_bytes": peak}


# the tiny configuration of tests/test_train_step.py
TINY_TRAIN = dict(
    num_chars=30, spec_channels=513, segment_size=2048, midi_start=-5, midi_end=75,
    octave_range=24, inter_channels=96, hidden_channels=64, filter_channels=96, n_heads=2,
    n_layers=1, kernel_size=3, p_dropout=0.1, resblock="1", resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 3]], upsample_rates=[8, 8, 2, 2], upsample_initial_channel=32,
    upsample_kernel_sizes=[16, 16, 4, 4], yin_channels=80, yin_start=15, yin_scope=50,
    yin_shift_range=15, n_speakers=3, gin_channels=16, posterior_layers=2, flow_n_flows=1,
    flow_wn_layers=1, dur_n_flows=1, yin_dec_layers=2,
)


def tiny_train_step_pair(seed, **train):
    """One f32 train step at the tiny configuration with the probe
    discriminator, on the CPU and on the card from the same weights, batch,
    noise and PhaseAug rotations, dropout off (CPU and card draw other
    masks), TF32 off, cuDNN deterministic; ``train`` overrides entries of
    hps.train (loss weights). Returns (hps, (cpu, card) states, metrics,
    generator outputs)."""
    from vits_torch.config import HParams
    from vits_torch.models.avocodo import probe_discriminator
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.ops.phaseaug import sample_phi
    from vits_torch.training.step import create_train_state, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    hps = HParams(
        train={**dict(learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9, lr_decay=0.999875,
                      segment_size=2048, c_mel=45, c_kl=1.0, c_yin=45.0), **train},
        data=dict(filter_length=1024, hop_length=256, win_length=1024, n_mel_channels=80,
                  mel_fmin=0.0, mel_fmax=None, sampling_rate=22050),
    )
    rng = np.random.default_rng(seed)
    b, t_x, t_y = 2, 9, 16
    batch = {
        "x": rng.integers(1, 30, (b, t_x)), "t": rng.integers(0, 6, (b, t_x)),
        "x_lengths": np.full(b, t_x), "spec_lengths": np.full(b, t_y),
        "spec": np.abs(rng.standard_normal((b, t_y, 513))).astype(np.float32),
        "ying": rng.uniform(0, 1, (b, t_y, 80)).astype(np.float32),
        "wav": (rng.standard_normal((b, t_y * 256, 1)) * 0.1).astype(np.float32),
        "sid": rng.integers(0, 3, b),
    }
    gen = torch.Generator().manual_seed(seed)
    noise = {
        "eps_spec": rng.standard_normal((b, t_y, 16)).astype(np.float32),
        "eps_yin": rng.standard_normal((b, t_y, 80)).astype(np.float32),
        "scope_shift": rng.integers(-15, 15, b).astype(np.int32),
        "e_q": rng.standard_normal((b, t_x, 2)).astype(np.float32),
        "slice_u": rng.uniform(0, 1, b).astype(np.float32),
        "phi_d": sample_phi(2 * b, gen).numpy(), "phi_g": sample_phi(2 * b, gen).numpy(),
    }
    states, outs, metrics = [], [], []
    for dev in ("cpu", "cuda"):
        torch.manual_seed(seed)
        model = SynthesizerTrn(**TINY_TRAIN, device="cpu")
        disc = probe_discriminator(segment_size=2048, device="cpu")
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        state = create_train_state(model.to(dev), disc.to(dev), hps, steps_per_epoch=10)
        out = {}
        hook = model.register_forward_hook(lambda m, a, o, out=out: out.update(o))
        metrics.append({k: v.cpu() for k, v in train_step(state, batch, hps, noise=noise).items()})
        hook.remove()
        states.append(state)
        outs.append(out)
    return hps, states, metrics, outs


def check_train_card_against_cpu(card, seed):
    """Phase 6, second half: one f32 train step at the tiny configuration
    with the probe discriminator, card against CPU."""
    hps, states, metrics, outs = tiny_train_step_pair(seed)
    (s_cpu, s_gpu), (m_cpu, m_gpu) = states, metrics
    for k in ("attn", "ids_slice"):
        if not torch.equal(outs[1][k].cpu(), outs[0][k]):
            raise AssertionError(f"train step card vs CPU: {k} differs")
    errs = {k: abs(m_gpu[k].item() - m_cpu[k].item()) for k in m_cpu}
    bad = [k for k in m_cpu if errs[k] > 1e-4 * abs(m_cpu[k].item()) + 1e-6]
    lr = hps.train.learning_rate
    worst_grad, worst_param = {}, 0.0
    for side in ("model", "disc"):
        total = m_cpu[f"grad_norm/{'g' if side == 'model' else 'd'}"].item()
        for (k, p_cpu), p_gpu in zip(getattr(s_cpu, side).named_parameters(),
                                     getattr(s_gpu, side).parameters()):
            g_err = (p_gpu.grad.cpu() - p_cpu.grad).norm().item()
            g_ref = p_cpu.grad.norm().item()
            # the decoder's gradients carry the yin losses through the Yingram
            # of the generated audio: an f32 FFT autocorrelation (cuFFT against
            # pocketfft) and cMNDF divisions by running sums, whose gradient
            # through exp(-yin) amplifies the summation order: 1.7e-3 of a
            # tensor's norm with the yin losses, 1e-4 without them
            # (tools/probe_step_grads.py)
            group = "decoder" if k.startswith("waveform_decoder.") else "rest"
            rel = 1e-2 if group == "decoder" else 1e-3
            if g_err > 1e-6 * total:
                worst_grad[group] = max(worst_grad.get(group, 0.0), g_err / g_ref)
            if g_err > rel * g_ref + 1e-6 * total:
                bad.append(f"grad {side}.{k}")
            p_err = (p_gpu.detach().cpu() - p_cpu.detach()).abs().max().item()
            worst_param = max(worst_param, p_err)
            if p_err > 2.01 * lr:  # Adam's first step: +-lr where a gradient is ~0
                bad.append(f"param {side}.{k}")
    print(f"{card} | train step card vs CPU, tiny config + probe D, f32, TF32 off, cuDNN "
          f"deterministic: attn and ids_slice exact; max|err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; gradients, worst relative error above 1e-6 of the global norm: "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst_grad.items()))
          + f"; updated parameters max|err| {worst_param:.3e} (tolerances: metrics rtol 1e-4; "
          f"gradients 1e-3 (decoder 1e-2) of the tensor's norm + 1e-6 of the global norm; "
          f"parameters 2.01 x lr = {2.01 * lr:.2e})")
    if bad:
        raise AssertionError(f"train step card vs CPU: {bad[:10]}")
    return errs, worst_grad, worst_param


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2

    from vits_torch import _build
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer

    card = card_line()
    print(card)
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    per_source = _build.build(sources)
    print(f"{card} | build {sources}: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})")

    hps = load_hparams(str(ROOT / "configs" / "config_cje.yaml"))
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    batch = synthetic_batch(hps, rng, dev)
    lengths = (batch["y_lengths"].cpu().numpy(), batch["x_lengths"].cpu().numpy())
    mas_rows = check_mas(card, lengths)

    torch.manual_seed(args.seed)
    model = build_synthesizer(hps)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{card} | generator: {n_params} parameters, configs/config_cje.yaml")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    forward_launches, _ = check_forward(card, model, batch, gen, hps)
    check_infer(card, model, hps, rng, gen)
    del model
    torch.cuda.empty_cache()
    train = {bf16: check_train(card, hps, batch, args.seed, bf16) for bf16 in (True, False)}
    check_card_against_cpu(card, args.seed)
    check_train_card_against_cpu(card, args.seed)

    kernels = []
    # mas_fused replaces both Pallas kernels; the pair is off the main path
    for name, line, key in (("mas_fused", 36, "fused"), ("mas_forward", 36, "fw"),
                            ("mas_backtrack", 57, "bt")):
        ms, plain_ms, (b_ms, b_by) = mas_rows["main"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": "vits_torch/csrc/mas.cu",
            "replaces": f"vits_tpu/ops/mas_pallas.py:{line}",
            # the main path: the train steps under the config's bf16 policy
            "launches": train[True]["launches"][name],
            "max_abs_err": mas_rows["err"][name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_train_step": {
                "bf16": train[True]["launches_per_step"] if name == "mas_fused" else 0,
                "f32": train[False]["launches_per_step"] if name == "mas_fused" else 0,
            },
            "launches_per_forward": forward_launches[name],
        })
    kernels[0]["also_replaces"] = "vits_tpu/ops/mas_pallas.py:57"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
