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
  2. kernels   the fused MAS kernel (the main path's), the wide one and the
               first port's forward + backtrack pair against the plain
               version, exact, at the test shapes, the edge cases (t_y < t_x,
               t_x = 1, zero-length items, t_y == t_x with partial lengths),
               the main-path shape and the largest bucket (64, 1500, 384);
               the fused kernel and the pair timed in turns (pair, fused,
               fused, pair) with their bounds, and at the main-path shape
               mas_wide against mas_fused in turns, for the record (route
               keeps mas_fused); then the shapes mas_fused cannot take,
               (16, 1500, 512), (16, 2000, 1024), (8, 2000, 384), (4, 3000,
               2052) and (2, 13000, 64): the plan of each and the clusters
               the card holds at once (at least 1), maximum_path launches
               mas_wide once each, exact; at the first two and at (16, 1500,
               1024) mas_wide and the pair timed in turns (pair, wide, wide,
               pair) with the bound, and mas_wide must be the faster; then
               the benchmark scripts' train shapes (32, 400, 128) and (16,
               400, 128), random lengths with item 0 full: maximum_path
               launches mas_fused once each, exact, and its time and bound
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
  7. serve     serve/engine.py::TTSEngine on configs/config_cje.yaml at full
               width, max_frames=1000, random weights from the seed, TF32
               convolutions as PyTorch defaults: synthesize one text a
               language (ZH, JA, EN, P, mixed) and one over 384 ids (phrase
               split), each median/min/max of 5 with its real-time factor
               and IPA; synthesize_batch of 8 (one batch) against each
               request alone; synthesize_streaming (first chunk against the
               whole call, equal to synthesize_chunked bit for bit);
               voice_conversion of 3 s and of audio longer than the largest
               VC bucket (cross-faded windows); DynamicBatcher with 16
               requests from threads; synthesize from new threads; the HTTP
               API on 127.0.0.1 (health, WAV, JSON, each request timed); MAS
               launched 0 times; then the tiny test
               configuration's engine on the card and on the CPU with the
               same weights and noise, TF32 off: audio held to the CPU's
  8. train run the training entry point, training/train.py::main, in this
               process at the full width and depth of configs/config_cje.yaml
               with its own train section (batch 64, bf16, segment 8192,
               flagship Avocodo D): 128 training and 16 validation synthetic
               voices of 301-400 frames with ZH/JA/EN/mixed texts over the
               5 speakers, preprocessed and feature-cached by the port; 2
               epochs of 2 steps with evaluate and a checkpoint every 2
               steps; then a resumed run to 3 epochs from the same directory;
               then TTSEngine serves the newest eval_{step} (strict load).
               Step times, loader waits, peak memory, losses, evaluate and
               checkpoint times; mas_fused once a train step and once a
               validation batch, the pair never
  9. ddp       (a) the train CLI under torchrun with --distributed, world 1
               over NCCL, on phase 8's corpus and config (2 epochs, B=64,
               bf16): exit 0, no process of the run left, its logged losses
               at steps 2 and 4 those of phase 8's first run (rtol 1e-3), its
               eval_4 served by TTSEngine (strict load), wall time, peak
               memory and MAS launches from its train.log; (b) two ranks on
               the one card over gloo (spawned, joined), phase 6's tiny
               configuration with rank 0's rows long and rank 1's short:
               one DDP train_step a rank against one process's train_step on
               the global batch with the same noise, TF32 off (phase 6's
               tolerances for metrics and gradients; updated parameters
               within 1e-3 of the update's norm on the elements whose
               gradient sign is settled, elsewhere 2.01 x lr),
               mas_fused once a rank; then graft_entry.entry() and
               graft_entry.dryrun_multichip(2) on the card, and the host
               MAS (ops/mas_native.py) against maximum_path_torch at phase
               2's main-path shape, exactly
 10. tp        graft_entry.dryrun_multichip_2d(4) on the card; then four
               gloo ranks on cuda:0 as a 2 x 2 (data, model) mesh at full
               CJE width (flagship D, segment 8192, f32, TF32 off,
               deterministic kernels, 2 rows a data rank), the HiFi-GAN
               decoder split on output channels over the model ranks
               (parallel/mesh.py::tp_shard_generator): one train_step a rank
               against one process on the global batch of 4 with the same
               draws (metrics rtol 1e-4; the gathered parameters and
               gradients held as in 9 (b)); model peers' replicated
               parameters bit for bit equal; mas_fused once a rank; step
               wall and peak memory a rank
 11. study     tools/convergence_torch.py at the study's configuration (B=16,
               upsample_initial_channel 256, 4 text-encoder layers, bf16):
               gen (280 voices), 2 epochs of train with an evaluation and a
               checkpoint every 16 steps, analyze and synth; finite curves,
               8 held-out texts, mas_fused once a train step and once a
               validation batch
 12. bf16-cpu  the tiny configuration's train step (probe discriminator)
               under the bf16 policy and in f32, on the card and on the CPU,
               from the same weights and draws on the CPU f32 step's MAS
               path, TF32 off, cuDNN deterministic: each group's forward and
               gradient gap against the CPU's f32 step (posterior encoders,
               the rest of the generator, the decoder, the discriminator);
               every group's card gaps within 1.15 x the CPU's plus the
               card's f32 gap
 13. migrate   a reference (Aloento/VITS) checkpoint pair at full CJE width
               (random weights from the seed): Model_Eval_{N}.pth with the
               generator's module.-prefixed state_dict under "model_g", and
               Model_Train_{N}.pth with the flagship D's under "model_d" and
               an optimizer state, each with entries the converter does not
               read; python -m vits_torch.utils.convert_reference ...
               --train-pth ... exits 0; TTSEngine loads eval_{N} strictly,
               its weights the source's bit for bit, and synthesizes one text
               a language with the lengths of an engine built from the source
               state_dict and within phase 7's 1e-2 of the peak, MAS launched
               0 times; then merge_compatible of G from eval_{N} and D from
               disc_{N} into the config's train state (every entry used, none
               skipped), 1 warm-up and 3 timed train steps under the config's
               bf16 policy on phase 5's batch: finite losses, every parameter
               moved, mas_fused once a step
14. long text  configs/config_cje.yaml with max_text_len 510 (T_x 1024) at its
               top bucket (T_y 1500), full width and depth, the config's
               bf16 policy, flagship D: B=16 of 1000-1500 frames and 400-1024
               symbols, 1 warm-up and 3 timed train steps; mas_wide once a
               step and mas_fused never, every step's path equal to
               maximum_path_torch on its inputs, finite losses, step times
               and peak memory; mas_wide timed on the last step's inputs
15. bench      the port's benchmark scripts as a user runs them, each a
               subprocess from the repo root at full CJE width: python3
               bench_torch.py, python3 bench_train_torch.py --bf16, the same
               with --iters 2 --trace <tmp>, python3 bench_matrix_torch.py.
               Each exits 0; its last stdout line (the matrix's last six) is
               JSON with every key of the JAX script's line (read from
               bench.py's, bench_train.py's and bench_matrix.py's source),
               every number finite and > 0, train_mfu in (0, 1], device
               naming this card; the trace holds CUDA kernel events (their
               busy time and idle share printed); each script's MAS launches
               (its last stderr line) are one mas_fused a train step and no
               other
Then no process the phases started (loader workers, nvcc, torchrun, ranks)
may be left running: any still alive after 10 s is killed and the script
fails.

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}. Every number printed carries the card's
name and power limit. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_B, MAIN_T_Y, MAIN_T_X = 16, 400, 191
# shapes that mas_fused cannot take, so maximum_path launches mas_wide: T_x
# of max_text_len 254 and 510 at the top buckets, the CJE text bound with a
# 2000-frame bucket, T_x over 2048, T_y past the first port's backtrack limit (12,288)
WIDE_CASES = [(16, 1500, 512), (16, 2000, 1024), (8, 2000, 384), (4, 3000, 2052),
              (2, 13000, 64)]
WIDE_TIMED = [(16, 1500, 512), (16, 2000, 1024), (16, 1500, 1024)]
# the benchmark scripts' train steps: bench_torch.py's B=32 and
# bench_train_torch.py's and bench_matrix_torch.py's B=16, x 400 frames x 128 symbols
BENCH_MAS_CASES = [(32, 400, 128), (16, 400, 128)]
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


def descendants() -> dict[int, str]:
    """{pid: command line} of every live process below this one (/proc)."""
    children: dict[int, list[int]] = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            state, ppid = stat.read_text().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError, IndexError):
            continue
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(stat.parent.name))
    found, todo = {}, list(children.get(os.getpid(), []))
    while todo:
        pid = todo.pop()
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode().strip()
        except OSError:
            continue
        found[pid] = cmd
        todo += children.get(pid, [])
    return found


def stop_descendants(wait_s: float = 10.0) -> dict[int, str]:
    """Waits up to wait_s for the processes the phases started to end, kills
    those still alive, and returns them."""
    deadline = time.perf_counter() + wait_s
    while (left := descendants()) and time.perf_counter() < deadline:
        time.sleep(0.1)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return left


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


def wall_stats(fn, n=5):
    """((median, min, max) wall ms of fn() + synchronize over n runs after
    one warm-up run, the last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)), min(times), max(times)), out


def host_ms(fn, iters=10) -> tuple[float, float, float]:
    """(median, min, max) wall ms of fn() + synchronize over iters runs,
    after one warm-up run."""
    return wall_stats(fn, iters)[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mas_only(**counts) -> dict:
    """The MAS launch counts a run must show: those named, every other
    kernel's 0."""
    from vits_torch.ops import mas_cuda

    return {**dict.fromkeys(mas_cuda.launches, 0), **counts}


def mas_case(b, t_y, t_x, seed, t_ys=None, t_xs=None, full_first=False):
    """Random scores with lengths t_y >= t_x (drawn unless given; item 0 at
    the full T_y x T_x if full_first), on the card."""
    rng = np.random.default_rng(seed)
    neg = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    if t_ys is None:
        t_xs = rng.integers(2, t_x + 1, size=b)
        t_ys = np.maximum(rng.integers(t_x, t_y + 1, size=b), t_xs)
        if full_first:
            t_ys[0], t_xs[0] = t_y, t_x
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

    err = {"mas_fused": 0.0, "mas_forward": 0.0, "mas_backtrack": 0.0, "mas_wide": 0.0}
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
        e_w = (mas_cuda.mas_wide(neg, mask) - ref).abs().max().item()
        torch.cuda.synchronize()
        if t_ys is not None and t_y == t_x and t_ys[0] == t_y and t_xs[0] == t_x \
                and not torch.equal(full[0].cpu(), torch.eye(t_y)):
            raise AssertionError("MAS: t_y == t_x must give the identity path")
        print(f"{card} | mas check B={b} T_y={t_y} T_x={t_x}: fused max|err|={e_u} "
              f"maximum_path max|err|={e_p} forward max|err|={e_f} backtrack max|err|={e_b} "
              f"wide max|err|={e_w}")
        if e_u or e_p or e_f or e_b or e_w:
            raise AssertionError("MAS kernel disagrees with the plain version")
        for k, e in (("mas_fused", max(e_u, e_p)), ("mas_forward", e_f), ("mas_backtrack", e_b),
                     ("mas_wide", e_w)):
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
        fused_bound = mas_bound(ty, tx, t_y, t_x)
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
        if label == "main":
            # for the record (route keeps mas_fused here): mas_wide on the
            # same inputs, in turns with mas_fused
            def wide_kernel():
                return mas_cuda.mas_wide(neg, mask)

            turns = [cuda_ms(fused), cuda_ms(wide_kernel), cuda_ms(wide_kernel), cuda_ms(fused)]
            rows["wide_at_main"] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
            print(f"{card} | mas main B={b} T_y={t_y} T_x={t_x}: in turns fused {turns[0]:.4f}, "
                  f"wide {turns[1]:.4f}, wide {turns[2]:.4f}, fused {turns[3]:.4f} ms; mas_wide "
                  f"{rows['wide_at_main'][0]:.4f} ms against mas_fused {rows['wide_at_main'][1]:.4f} "
                  f"ms (route keeps mas_fused)")
    print(f"{card} | mas note: the fused kernel's time is its serial chain of t_y DP row "
          f"steps and t_y walk steps on one warp an item, not bytes")

    # the shapes mas_fused refuses: maximum_path launches mas_wide, once
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (b, t_y, t_x) in enumerate(WIDE_CASES):
        plan = mas_cuda.wide_plan(b, t_y, t_x, sms)
        clusters = mas_cuda._lib().mas_wide_active_clusters(b, t_y, t_x)
        print(f"{card} | mas wide B={b} T_y={t_y} T_x={t_x}: plan {plan}, "
              f"{clusters} clusters at once (cudaOccupancyMaxActiveClusters)")
        if clusters < 1:
            raise AssertionError(f"mas wide: the card holds no cluster of the plan {plan}")
        neg, mask, _, _ = mas_case(b, t_y, t_x, 200 + i, full_first=True)
        before = dict(mas_cuda.launches)
        full = mas.maximum_path(neg, mask)
        torch.cuda.synchronize()
        launched = {k: mas_cuda.launches[k] - before[k] for k in before}
        ref = mas.maximum_path_torch(neg, mask)
        e_p = (full - ref).abs().max().item()
        print(f"{card} | mas wide B={b} T_y={t_y} T_x={t_x}: route "
              f"{mas_cuda.route(t_y, t_x)}, maximum_path launched {launched}, max|err|={e_p}")
        if launched != mas_only(mas_wide=1):
            raise AssertionError(f"mas wide: maximum_path must launch mas_wide once, {launched}")
        if e_p:
            raise AssertionError("mas_wide disagrees with the plain version")
        err["mas_wide"] = max(err["mas_wide"], e_p)
    wide = {}
    for b, t_y, t_x in WIDE_TIMED:
        neg, mask, ty, tx = mas_case(b, t_y, t_x, 7, full_first=True)

        def pair():
            return mas_cuda.mas_backtrack(mas_cuda.mas_forward(neg, ty, tx), ty, tx)

        def wide_kernel():
            return mas_cuda.mas_wide(neg, mask)

        # the first port's pair takes these shapes too (T_x <= 4096, T_y <= 12,288)
        turns = [cuda_ms(pair, iters=10), cuda_ms(wide_kernel, iters=10),
                 cuda_ms(wide_kernel, iters=10), cuda_ms(pair, iters=10)]
        w_ms, pair_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        plain_ms = cuda_ms(lambda: mas.maximum_path_torch(neg, mask), iters=2, warmup=1)
        b_ms, b_by = mas_bound(ty, tx, t_y, t_x)
        wide[(b, t_y, t_x)] = (w_ms, plain_ms, (b_ms, b_by))
        print(f"{card} | mas wide B={b} T_y={t_y} T_x={t_x}: in turns pair {turns[0]:.4f}, "
              f"wide {turns[1]:.4f}, wide {turns[2]:.4f}, pair {turns[3]:.4f} ms; mas_wide "
              f"{w_ms:.4f} ms against pair {pair_ms:.4f} ms ({pair_ms / w_ms:.2f}x), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by} ({w_ms / b_ms:.1f}x the bound)")
        if w_ms >= pair_ms:
            raise AssertionError(f"mas wide ({b}, {t_y}, {t_x}): mas_wide is not faster than "
                                 "the pair")
    # the benchmark scripts' shapes (phase 15): maximum_path launches mas_fused
    bench = {}
    for i, (b, t_y, t_x) in enumerate(BENCH_MAS_CASES):
        neg, mask, ty, tx = mas_case(b, t_y, t_x, 300 + i, full_first=True)
        before = dict(mas_cuda.launches)
        full = mas.maximum_path(neg, mask)
        torch.cuda.synchronize()
        launched = {k: mas_cuda.launches[k] - before[k] for k in before}
        e_p = (full - mas.maximum_path_torch(neg, mask)).abs().max().item()
        ms = cuda_ms(lambda: mas_cuda.mas_fused(neg, mask))
        plain_ms = cuda_ms(lambda: mas.maximum_path_torch(neg, mask), iters=2, warmup=1)
        b_ms, b_by = mas_bound(ty, tx, t_y, t_x)
        bench[(b, t_y, t_x)] = (ms, plain_ms, (b_ms, b_by))
        print(f"{card} | mas bench B={b} T_y={t_y} T_x={t_x}: route {mas_cuda.route(t_y, t_x)}, "
              f"maximum_path launched {launched}, max|err|={e_p}; mas_fused {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by} ({ms / b_ms:.1f}x the bound)")
        if launched != mas_only(mas_fused=1):
            raise AssertionError(f"mas bench: maximum_path must launch mas_fused once, {launched}")
        if e_p:
            raise AssertionError("mas_fused disagrees with the plain version")
        err["mas_fused"] = max(err["mas_fused"], e_p)
    return {"err": err, "main": rows["main"], "wide": wide, "wide_at_main": rows["wide_at_main"],
            "bench": bench}


def mas_bound(ty, tx, t_y, t_x):
    """The bound (ms, by) of maximum_path at lengths ty, tx of a [B, T_y,
    T_x] batch, whichever kernel computes it: read the scores inside the
    rectangles and the mask's first column and row, write the whole f32
    path; an add, a max and a compare a cell."""
    b = ty.numel()
    cells = float((ty.double() * tx.double()).sum())
    return bound_ms(4 * cells + 4.0 * b * (t_y + t_x) + 4.0 * b * t_y * t_x, 3 * cells)


def synthetic_batch(hps, rng, dev, b=MAIN_B, t_y=MAIN_T_Y, t_x=MAIN_T_X, y_low=300,
                    x_low=129):
    """B utterances of y_low..T_y frames with x_low..T_x symbols, never more
    symbols than frames (B=16, 300-400 frames, 129-191 symbols unless
    given), item 0 at the full T_y x T_x; their waveforms [B, T_y * hop, 1]
    and the linear spectrograms and yingrams the port computes from them on
    the card."""
    from vits_torch.ops.stft import spectrogram
    from vits_torch.ops.yin import Yingram
    from vits_torch.text.symbols import symbols

    d = hps.data
    hop = d.hop_length
    y_lengths = rng.integers(y_low, t_y + 1, size=b)
    y_lengths[0] = t_y
    x_lengths = rng.integers(x_low, t_x + 1, size=b)
    x_lengths[0] = t_x
    x_lengths = np.minimum(x_lengths, y_lengths)
    n = np.arange(t_y * hop)
    f0 = rng.uniform(90, 300, size=(b, 1))
    wav = (0.4 * np.sin(2 * np.pi * f0 * n / d.sampling_rate)
           + 0.2 * np.sin(4 * np.pi * f0 * n / d.sampling_rate)
           + 0.02 * rng.standard_normal((b, n.size)))
    wav *= n[None, :] < (y_lengths[:, None] * hop)
    wav = torch.from_numpy(wav.astype(np.float32)).to(dev)
    spec = spectrogram(wav, d.filter_length, hop, d.win_length)
    left = d.filter_length - hop
    right = left + (-wav.shape[1]) % hop + hop * (wav.shape[1] % hop == 0)
    yingram = Yingram(d.sampling_rate, hop, d.ying_window, d.tau_max, d.midi_start,
                      d.midi_end, d.octave_range)
    ying = yingram(torch.nn.functional.pad(wav, (left, right)))
    if spec.shape != (b, t_y, d.filter_length // 2 + 1) or ying.shape != (b, t_y, d.midis):
        raise AssertionError(f"features: spec {tuple(spec.shape)}, yingram {tuple(ying.shape)}")
    x = torch.from_numpy(rng.integers(1, len(symbols), (b, t_x))).to(dev)
    t = torch.from_numpy(rng.integers(0, 6, (b, t_x))).to(dev)
    sid = torch.from_numpy(rng.integers(0, len(d.speakers), b)).to(dev)
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
    if launches != mas_only(mas_fused=1):
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
    if launches != mas_only(mas_fused=n):
        raise AssertionError(f"train step {label}: mas_fused must launch once a step")
    if not all(np.isfinite(v) for m in (first, last) for v in m.values()):
        raise AssertionError(f"train step {label}: a loss is not finite")
    if not all(moved):
        raise AssertionError(f"train step {label}: {len(moved) - sum(moved)} tensors never moved")
    del state, model, disc, start
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches, "peak_bytes": peak}


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
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.models.avocodo import probe_discriminator
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.training.step import create_train_state, train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    hps = tiny_hps(**train)
    b, t_x, t_y = 2, 9, 16
    batch, noise = policy_batch(TINY_TRAIN["inter_channels"], TINY_TRAIN["yin_channels"], b, t_x,
                                [t_y] * b, seed, n_speakers=TINY_TRAIN["n_speakers"])
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


BF16_GROUPS = ("posterior encoders", "generator rest", "decoder", "discriminator")


def param_group(side: str, name: str) -> str:
    """The bf16 policy's group of a train state's parameter."""
    if side == "disc":
        return "discriminator"
    if name.startswith(("posterior_encoder.", "pitch_encoder.")):
        return "posterior encoders"
    return "decoder" if name.startswith("waveform_decoder.") else "generator rest"


def policy_batch(inter_channels, yin_channels, b, t_x, t_ys, seed, n_speakers=2):
    """A train batch of ``b`` rows (frames ``t_ys``) and every draw of one
    step, as numpy arrays from ``seed``."""
    from vits_torch.ops.phaseaug import sample_phi

    rng = np.random.default_rng(seed)
    t_y = max(t_ys)
    batch = {
        "x": rng.integers(1, 30, (b, t_x)), "t": rng.integers(0, 6, (b, t_x)),
        "x_lengths": np.full(b, t_x), "spec_lengths": np.asarray(t_ys),
        "spec": np.abs(rng.standard_normal((b, t_y, 513))).astype(np.float32),
        "ying": rng.uniform(0, 1, (b, t_y, yin_channels)).astype(np.float32),
        "wav": (rng.standard_normal((b, t_y * 256, 1)) * 0.1).astype(np.float32),
        "sid": rng.integers(0, n_speakers, b),
    }
    gen = torch.Generator().manual_seed(seed)
    noise = {
        "eps_spec": rng.standard_normal((b, t_y, inter_channels - yin_channels)).astype(np.float32),
        "eps_yin": rng.standard_normal((b, t_y, yin_channels)).astype(np.float32),
        "scope_shift": rng.integers(-15, 15, b).astype(np.int32),
        "e_q": rng.standard_normal((b, t_x, 2)).astype(np.float32),
        "slice_u": rng.uniform(0, 1, b).astype(np.float32),
        "phi_d": sample_phi(2 * b, gen).numpy(), "phi_g": sample_phi(2 * b, gen).numpy(),
    }
    return batch, noise


def policy_step(make_model, make_disc, hps, batch, noise, dev, bf16, seed, attn=None):
    """One train step on ``dev`` under the bf16 policy or in f32, from the
    weights ``seed`` makes, dropout off; ``attn`` (a MAS path) replaces
    MAS, so that runs in other precisions align the same frames. Returns
    the step's flat forward outputs and gradients by group, and its path."""
    from vits_torch.models import synthesizer as syn
    from vits_torch.training.step import create_train_state, train_step

    torch.manual_seed(seed)
    model, disc = make_model(bf16), make_disc(bf16)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    state = create_train_state(model.to(dev), disc.to(dev), hps, steps_per_epoch=10)
    out, d_out = {}, []
    hooks = [model.register_forward_hook(lambda m, a, o: out.update(o)),
             disc.register_forward_hook(lambda m, a, o: d_out.append(o[1]))]
    mas = syn.maximum_path
    if attn is not None:
        syn.maximum_path = lambda neg_cent, mask: attn.to(neg_cent.device)
    try:
        train_step(state, batch, hps, noise=noise)
    finally:
        syn.maximum_path = mas
        for h in hooks:
            h.remove()

    def flat(ts):
        return torch.cat([t.detach().float().flatten().cpu() for t in ts])

    fwd = {
        "posterior encoders": flat([out["m_q"], out["logs_q"]]),
        "generator rest": flat([out["z_p"], out["m_p"], out["logs_p"]]),
        "decoder": flat(out["wav_hier"]),
        "discriminator": flat(d_out[0]),  # the D step's logits of the generated audio
    }
    grads = {g: [] for g in BF16_GROUPS}
    for side in ("model", "disc"):
        for k, p in getattr(state, side).named_parameters():
            grads[param_group(side, k)].append(p.grad)
    return {"fwd": fwd, "grad": {g: flat(v) for g, v in grads.items()},
            "attn": out["attn"].detach().cpu()}


def policy_gaps(run, ref) -> dict:
    """{group: (forward gap, gradient gap)}, each ||run - ref|| / ||ref||."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return {g: (rel(run["fwd"][g], ref["fwd"][g]), rel(run["grad"][g], ref["grad"][g]))
            for g in BF16_GROUPS}


def policy_gap_table(make_model, make_disc, hps, batch, noise, seed, devices=("cpu", "cuda")):
    """The f32 step on the CPU, then the bf16 step on each device and the
    f32 step on each other device, all on the CPU's MAS path, TF32 off and
    cuDNN deterministic: {(device, "bf16"|"f32"): {group: (forward gap,
    gradient gap)}} against the CPU's f32 step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    ref = policy_step(make_model, make_disc, hps, batch, noise, "cpu", False, seed)
    table = {}
    for dev in devices:
        for bf16 in (True, False) if dev != "cpu" else (True,):
            run = policy_step(make_model, make_disc, hps, batch, noise, dev, bf16, seed,
                              attn=ref["attn"])
            table[(dev, "bf16" if bf16 else "f32")] = policy_gaps(run, ref)
    return table


# phase 12: under bf16 each group's card gap may be at most this multiple of
# the CPU's (both against the CPU's f32 step), plus the card's f32 gap. The
# same rounding code runs on both sides, so this sees the card's bf16
# kernels (cuDNN's algorithms, their reductions), not where the port
# rounds. Readings at this phase's shapes on an NVIDIA H100 80GB HBM3 at
# 700 W (tools/bf16_bisect.py phase12): 0.986-1.038 x in every group; with
# the card's bf16 convs made to sum split-K partials rounded to bf16 (a
# fault a reduction in bf16 would make, ``--fault``), four partials
# 1.17-1.32 x in the posterior encoders and the rest of the generator, two
# 1.25 x in the rest's gradient. At the study's width the sound card read
# 0.97-1.23 x (tools/bf16_bisect.py gaps), so the limit holds at these
# shapes only.
BF16_CARD_OVER_CPU = 1.15


def check_bf16_card_against_cpu(card, seed):
    """Phase 12: one train step at the tiny configuration (probe D) under
    the bf16 policy on the card and on the CPU, and in f32 on both, from
    the same weights and draws on the same MAS path, TF32 off: each group's
    forward and gradient gap against the CPU's f32 step. Every group's card
    gaps must stay within BF16_CARD_OVER_CPU x the CPU's, plus the card's
    own f32 gap."""
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.models.avocodo import probe_discriminator
    from vits_torch.models.synthesizer import SynthesizerTrn

    batch, noise = policy_batch(TINY_TRAIN["inter_channels"], TINY_TRAIN["yin_channels"], 2, 9,
                                [16, 12], seed, n_speakers=TINY_TRAIN["n_speakers"])
    table = policy_gap_table(
        lambda bf16: SynthesizerTrn(**TINY_TRAIN, bf16=bf16, device="cpu"),
        lambda bf16: probe_discriminator(segment_size=2048, bf16=bf16, device="cpu"),
        tiny_hps(), batch, noise, seed)
    for (dev, prec), gaps in table.items():
        print(f"{card} | bf16 policy, tiny config + probe D, {dev} {prec} against the CPU's "
              f"f32 step: " + ", ".join(f"{g} forward {f:.3e} gradient {d:.3e}"
                                        for g, (f, d) in gaps.items()))
    card_bf16, cpu_bf16, card_f32 = (table[k] for k in (("cuda", "bf16"), ("cpu", "bf16"),
                                                        ("cuda", "f32")))
    bad = [f"{group} {kind}" for group in BF16_GROUPS for i, kind in enumerate(("forward", "gradient"))
           if card_bf16[group][i] > BF16_CARD_OVER_CPU * cpu_bf16[group][i] + card_f32[group][i]]
    print(f"{card} | bf16 policy: card gap over CPU gap, " + ", ".join(
        f"{group} forward {card_bf16[group][0] / cpu_bf16[group][0]:.3f} gradient "
        f"{card_bf16[group][1] / cpu_bf16[group][1]:.3f}" for group in BF16_GROUPS)
        + f" (tolerance {BF16_CARD_OVER_CPU} x the CPU's gap + the card's f32 gap)")
    if bad:
        raise AssertionError(f"bf16 policy: the card's {bad} gaps exceed "
                             f"{BF16_CARD_OVER_CPU} x the CPU's")
    return table


SERVE_TEXTS = {
    "ZH": "[ZH]今天天气很好，我们一起去公园散步吧。[ZH]",
    "JA": "[JA]こんにちは、今日は東京で友達と会います。[JA]",
    "EN": "[EN]The quick brown fox jumps over the lazy dog near the river bank.[EN]",
    "P": "[P]ni3#hao3 shi4#jie4 zai4#jian4[P]",
    "mixed": "[ZH]你好[ZH][EN]nice to meet you[EN][JA]よろしくお願いします[JA]",
    "long": "[EN]On a quiet morning in early spring, the old lighthouse keeper walked slowly "
            "along the rocky shore to watch the ships. The wind was cold, but the sky was "
            "clear and bright, and far away the gulls were calling over the water.[EN]",
}
# 129-256 ids each after add_blank: one (text 256, frames 1000) group of 8
SERVE_BATCH = [
    "[ZH]今天天气很好，我们一起去公园散步吧。[ZH]",
    "[EN]Please remember to bring your umbrella, because the weather report says it will "
    "rain this afternoon.[EN]",
    "[JA]新しい図書館は駅の東口から歩いて五分のところにあります。[JA]",
    "[ZH]欢迎来到北京[ZH][EN]we hope you enjoy your stay in the city[EN]",
    "[P]jin1#tian1 tian1#qi4 hen3#hao3, wo3#men5 yi4#qi3 qu4 gong1#yuan2 san4#bu4 ba5.[P]",
    "[EN]The quick brown fox jumps over the lazy dog near the river bank.[EN]",
    "[EN]On a quiet morning in early spring, the old lighthouse keeper walked slowly along "
    "the rocky shore to watch the ships.[EN]",
    "[JA]昨日の夜、私は友達と一緒に駅の近くの小さなレストランで美味しいラーメンを食べました。[JA]",
]
# batch rows against the same request alone, on the card with TF32
# convolutions: cuDNN picks its algorithms per batch size, so the rows agree
# to TF32 rounding (10-bit mantissa) carried through the generator, not bit
# for bit: lengths must be equal and max|err| within this share of the row's
# peak (8.5e-4 measured on an H100)
BATCH_VS_SOLO_REL = 1e-2
# the decoder's init (normal, std 0.01) gives a near-constant hum of ~1e-3;
# the card-vs-CPU check raises its weight-norm gains so the audio has signal
DECODER_GAIN = 16
# the tiny configuration of tests/test_engine.py
TINY_SERVE_CFG = {
    "train": {"segment_size": 2048},
    "data": {
        "sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
        "win_length": 1024, "n_mel_channels": 80, "mel_fmin": 0.0, "mel_fmax": None,
        "add_blank": True, "speakers": ["A", "B"], "midi_start": -5, "midi_end": 75,
        "midis": 80, "ying_window": 2048, "ying_hop": 256, "tau_max": 2048,
        "octave_range": 24,
    },
    "model": {
        "inter_channels": 96, "hidden_channels": 48, "filter_channels": 64, "n_heads": 2,
        "n_layers": 1, "kernel_size": 3, "p_dropout": 0.0, "resblock": "1",
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]],
        "upsample_rates": [8, 8, 2, 2], "upsample_initial_channel": 32,
        "upsample_kernel_sizes": [16, 16, 4, 4], "gin_channels": 16, "yin_channels": 80,
        "yin_start": 15, "yin_scope": 50, "yin_shift_range": 15,
    },
}


def synthetic_voice(n, sr, seed):
    """A gliding two-partial tone with a little noise, float32 [n]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(n)
    return wav.astype(np.float32)


def seeded_noise(seed, shapes):
    """Numpy draws keyed by (seed, position): the same on every device."""
    return {k: np.random.default_rng([seed, i]).standard_normal(s).astype(np.float32)
            for i, (k, s) in enumerate(shapes.items())}


def check_serve(card, config_path, seed):
    """Phase 7: the serving path at full width on the card."""
    from vits_torch.ops import mas_cuda
    from vits_torch.serve import http_api
    from vits_torch.serve.batcher import DynamicBatcher
    from vits_torch.serve.engine import TTSEngine

    # phase 6 turned TF32 off; serving runs with PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    torch.manual_seed(seed)
    t0 = time.perf_counter()
    eng = TTSEngine(config_path, max_frames=1000)
    if eng.device.type != "cuda" or eng.model.device.type != "cuda":
        raise AssertionError(f"the engine runs on {eng.device}, not the card")
    sr, hop = eng.sampling_rate, eng.hop
    print(f"{card} | serve engine: {Path(config_path).name}, max_frames=1000, built in "
          f"{time.perf_counter() - t0:.2f} s")
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    out = {"synthesize": {}}

    def audio_ok(label, audio, min_len=1):
        if audio.dtype != np.float32 or audio.ndim != 1 or len(audio) < min_len \
                or not np.isfinite(audio).all():
            raise AssertionError(f"serve {label}: audio {audio.dtype} {audio.shape} not finite "
                                 f"or too short")

    for i, (lang, text) in enumerate(SERVE_TEXTS.items()):
        seq, _, ipa = eng.get_phoneme(text)
        n_seg = len(eng._split_segments(seq, seq, eng.TEXT_BUCKETS[-1]))
        ms, (phones, (rate, audio)) = wall_stats(
            lambda: eng.synthesize(text, speaker_id=i % 5, seed=seed + i))
        audio_ok(lang, audio)
        if rate != sr or phones != ipa or (lang == "long") != (n_seg > 1):
            raise AssertionError(f"serve {lang}: rate {rate}, {n_seg} segments")
        secs = len(audio) / sr
        out["synthesize"][lang] = dict(ms=ms, ids=len(seq), segments=n_seg, audio_s=secs)
        print(f"{card} | serve synthesize {lang}: {len(seq)} ids, {n_seg} segment(s), "
              f"{secs:.3f} s of audio; median {ms[0]:.2f} ms (min {ms[1]:.2f}, max "
              f"{ms[2]:.2f}, n=5; host clock), real-time factor {ms[0] / 1e3 / secs:.5f}; "
              f"IPA {ipa!r}")

    reqs = [dict(text=t, speaker_id=i % 5, seed=seed + 10 + i, scope_shift=(i % 3 - 1) * 4,
                 duration=(0.9, 1.0, 1.2)[i % 3]) for i, t in enumerate(SERVE_BATCH)]
    groups = {(eng._bucket(len(eng.get_phoneme(r["text"])[0])),
               eng._first_frames(len(eng.get_phoneme(r["text"])[0]), r["duration"])) for r in reqs}
    ms, batch = wall_stats(lambda: eng.synthesize_batch(reqs))
    worst, worst_rel, lengths_equal = 0.0, 0.0, True
    for r, a in zip(reqs, batch):
        if isinstance(a, Exception):
            raise AssertionError(f"serve batch: {a!r}")
        audio_ok("batch row", a)
        solo = eng._synthesize_request(r)
        if len(solo) != len(a):
            lengths_equal = False
            print(f"{card} | serve batch row {r['text'][:12]!r}: {len(a)} samples in the batch, "
                  f"{len(solo)} alone")
            continue
        err = float(np.abs(solo - a).max())
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(float(np.abs(solo).max()), 1e-12))
    secs = sum(len(a) for a in batch) / sr
    out["batch"] = dict(ms=ms, utterances_per_s=len(reqs) / (ms[0] / 1e3), audio_s=secs,
                        max_abs_err_vs_alone=worst, max_rel_err_vs_alone=worst_rel)
    print(f"{card} | serve synthesize_batch of {len(reqs)} ({len(groups)} group(s) "
          f"{sorted(groups)}): median {ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n=5), "
          f"{len(reqs) / (ms[0] / 1e3):.2f} utterances/s, {secs:.3f} s of audio, real-time "
          f"factor {ms[0] / 1e3 / secs:.5f}; rows against each request alone: lengths "
          f"{'equal' if lengths_equal else 'DIFFER'}, max|err| {worst:.3e}, {worst_rel:.3e} of "
          f"the row's peak (tolerance {BATCH_VS_SOLO_REL} of the peak; TF32 convolutions)")
    if not lengths_equal or worst_rel > BATCH_VS_SOLO_REL:
        raise AssertionError("serve batch: a row differs from its request alone")

    text = SERVE_TEXTS["long"]
    _, (_, chunked) = eng.synthesize_chunked(text, 1, seed=seed)
    t0 = time.perf_counter()
    _, stream = eng.synthesize_streaming(text, 1, seed=seed)
    chunks = [next(stream)]
    first_ms = (time.perf_counter() - t0) * 1e3
    chunks += list(stream)
    whole_ms = (time.perf_counter() - t0) * 1e3
    streamed = np.concatenate(chunks)
    audio_ok("stream", streamed)
    equal = streamed.shape == chunked.shape and np.array_equal(streamed, chunked)
    out["stream"] = dict(first_chunk_ms=first_ms, whole_ms=whole_ms, chunks=len(chunks))
    print(f"{card} | serve synthesize_streaming (the long text, chunk 128 + 2 x 16 frames): "
          f"first chunk after {first_ms:.2f} ms, all {len(chunks)} chunks after {whole_ms:.2f} "
          f"ms ({len(streamed) / sr:.3f} s of audio); equal to synthesize_chunked bit for bit: "
          f"{equal}")
    if not equal:
        raise AssertionError("serve: streamed chunks differ from synthesize_chunked")

    out["vc"] = {}
    for label, n in (("3 s", 3 * sr), ("windowed", eng.VC_BUCKETS[-1] + 3 * sr)):
        wav = synthetic_voice(n, sr, seed)
        ms, conv = wall_stats(lambda: eng.voice_conversion(wav, 0, 3, seed=seed), n=3)
        want = n if n > eng.VC_BUCKETS[-1] else n // hop * hop
        audio_ok(f"vc {label}", conv, want)
        if len(conv) != want:
            raise AssertionError(f"serve vc {label}: {len(conv)} samples, want {want}")
        windows = 1 if n <= eng.VC_BUCKETS[-1] else \
            -(-(n - eng.VC_OVERLAP) // (eng.VC_BUCKETS[-1] - eng.VC_OVERLAP))
        out["vc"][label] = dict(ms=ms, audio_s=n / sr, windows=windows)
        print(f"{card} | serve voice_conversion {label}: {n / sr:.3f} s in, {windows} window(s); "
              f"median {ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n=3), real-time factor "
              f"{ms[0] / 1e3 / (n / sr):.5f}")

    sizes = []
    synthesize_batch = eng.synthesize_batch

    def counted(reqs):
        sizes.append(len(reqs))
        return synthesize_batch(reqs)

    eng.synthesize_batch = counted
    batcher = DynamicBatcher(eng, max_batch=8, max_wait_ms=10.0)
    futs = [None] * 16
    try:
        def submit(i):
            futs[i] = batcher.submit(SERVE_BATCH[i % 8], speaker_id=i % 5, seed=seed + 100 + i)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        results = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        batcher.close()
        del eng.synthesize_batch
    for rate, audio in results:
        audio_ok("batcher", audio)
    secs = sum(len(a) for _, a in results) / sr
    out["batcher"] = dict(s=wall, utterances_per_s=16 / wall, audio_s=secs, batches=sizes)
    print(f"{card} | serve DynamicBatcher (max_batch 8, max_wait 10 ms), 16 requests from 16 "
          f"threads: {wall * 1e3:.2f} ms, {16 / wall:.2f} utterances/s, {secs:.3f} s of audio; "
          f"batches of {sizes} (the worker thread is new: its first batch pays a new thread's "
          f"first-call set-up, tools/probe_serve_threads.py)")

    # a request served from a thread that has not touched the card yet, as
    # each handler thread of the HTTP server is
    fresh = []

    def timed_synthesize():
        t0 = time.perf_counter()
        eng.synthesize(SERVE_TEXTS["EN"], 2, seed)
        torch.cuda.synchronize()
        fresh.append((time.perf_counter() - t0) * 1e3)

    for _ in range(3):
        th = threading.Thread(target=timed_synthesize)
        th.start()
        th.join(timeout=120)
    if len(fresh) != 3:
        raise AssertionError("serve: a synthesize from a new thread failed")
    out["fresh_thread_ms"] = fresh
    print(f"{card} | serve synthesize EN, each call from a new thread: "
          + ", ".join(f"{v:.2f}" for v in fresh) + " ms (host clock; the same call from the "
          f"main thread: median {out['synthesize']['EN']['ms'][0]:.2f} ms)")

    server = http_api.serve(eng, "127.0.0.1", 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    body = {"text": SERVE_TEXTS["EN"], "speaker_id": 2, "seed": seed}

    def post(payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers["Content-Type"], r.read()

    http_ms = []
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
        http_ms.append((time.perf_counter() - t0) * 1e3)
        for payload in (body, dict(body, format="json"), body, body):
            t0 = time.perf_counter()
            ctype_i, data = post(payload)
            http_ms.append((time.perf_counter() - t0) * 1e3)
            if payload.get("format") == "json":
                js = json.loads(data)
            else:
                ctype, wav = ctype_i, data
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    ipa, (_, ref) = eng.synthesize(SERVE_TEXTS["EN"], 2, seed)
    if health != {"status": "ok", "sampling_rate": sr} or ctype != "audio/wav" \
            or wav[:4] != b"RIFF" or len(wav) != 44 + 2 * len(ref) \
            or js["ipa"] != ipa or js["num_samples"] != len(ref):
        raise AssertionError("serve: the HTTP round trip disagrees with the engine")
    out["http_ms"] = http_ms
    print(f"{card} | serve HTTP API on 127.0.0.1:{port}: /health ok in {http_ms[0]:.2f} ms; "
          f"/synthesize as WAV ({len(wav)} bytes) {http_ms[1]:.2f} ms, as JSON "
          f"({js['num_samples']} samples, IPA as the engine's) {http_ms[2]:.2f} ms, as WAV "
          f"again {http_ms[3]:.2f} and {http_ms[4]:.2f} ms (a handler thread each)")

    launches = dict(mas_cuda.launches)
    print(f"{card} | serve: MAS launches over the whole phase {launches}")
    if any(launches.values()):
        raise AssertionError("serving must not run MAS")
    out["mas_launches"] = launches
    del eng
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = check_serve_card_against_cpu(card, seed)
    return out


def check_serve_card_against_cpu(card, seed):
    """Phase 7, last part: the tiny configuration's engine on the card and
    on the CPU with the same weights and noise, TF32 off."""
    import yaml

    from vits_torch.serve.engine import TTSEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as d:
        cfg = Path(d) / "tiny.yaml"
        cfg.write_text(yaml.safe_dump(TINY_SERVE_CFG))
        torch.manual_seed(seed)
        cpu = TTSEngine(str(cfg), max_frames=96, device="cpu", noise_fn=seeded_noise)
        gpu = TTSEngine(str(cfg), max_frames=96, device="cuda", noise_fn=seeded_noise)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, prm in cpu.model.named_parameters():
            if not prm.any():  # zero-init heads: make the flows no identity
                prm.copy_(0.1 * torch.randn(prm.shape, generator=gen))
            if name.startswith("waveform_decoder.") and name.endswith("weight_g"):
                prm.mul_(DECODER_GAIN)
    gpu.model.load_state_dict(cpu.model.state_dict())
    texts = ["[P]ni3#hao3 shi4#jie4[P]", SERVE_TEXTS["mixed"]]
    wav = synthetic_voice(5000, 22050, seed)
    runs = {
        "synthesize": lambda e: [e.synthesize(t, 1, seed=seed + i, scope_shift=3)[1][1]
                                 for i, t in enumerate(texts)],
        "batch": lambda e: e.synthesize_batch([dict(text=t, seed=seed + i, duration=1.1)
                                               for i, t in enumerate(texts)]),
        "chunked": lambda e: [e.synthesize_chunked(texts[1], 0, seed=seed, chunk_frames=16)[1][1]],
        "voice_conversion": lambda e: [e.voice_conversion(wav, 0, 1, seed=seed)],
    }
    worst, peak = {}, 0.0
    for name, run in runs.items():
        for ref, got in zip(run(cpu), run(gpu)):
            if ref.shape != got.shape:
                raise AssertionError(f"serve card vs CPU {name}: {got.shape} against {ref.shape}")
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                       err_msg=f"serve card vs CPU {name}")
            worst[name] = max(worst.get(name, 0.0), float(np.abs(got - ref).max()))
            peak = max(peak, float(np.abs(ref).max()))
    print(f"{card} | serve card vs CPU, tiny config (decoder gains x{DECODER_GAIN}, audio peak "
          f"{peak:.3f}), TF32 off, same weights and noise: lengths equal, max|err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + " (tolerance rtol 1e-4, atol 1e-4)")
    return worst


RUN_TRAIN, RUN_VAL, RUN_FRAMES = 128, 16, (301, 400)
RUN_TEXTS = [
    "[ZH]今天天气很好，我们一起去公园散步吧。[ZH]",
    "[ZH]欢迎来到北京，希望你喜欢这座城市。[ZH]",
    "[JA]こんにちは、今日は東京で友達と会います。[JA]",
    "[JA]新しい図書館は駅の東口から歩いて五分です。[JA]",
    "[EN]The quick brown fox jumps over the lazy dog.[EN]",
    "[EN]Please remember to bring your umbrella this afternoon.[EN]",
    "[ZH]你好[ZH][EN]nice to meet you[EN][JA]よろしく[JA]",
    "[EN]Good morning[EN][ZH]早上好[ZH]",
]


def write_run_dataset(root: Path, hps, seed: int):
    """RUN_TRAIN + RUN_VAL int16 synthetic voices of RUN_FRAMES frames (all in
    the (300, 400] bucket) and raw filelists (path|speaker|tagged text)."""
    import scipy.io.wavfile

    d = hps.data
    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i in range(RUN_TRAIN + RUN_VAL):
        frames = int(rng.integers(RUN_FRAMES[0], RUN_FRAMES[1] + 1))
        wav = synthetic_voice(frames * d.hop_length, d.sampling_rate, seed + i)
        name = f"wavs/utt{i:03d}.wav"
        scipy.io.wavfile.write(root / name, d.sampling_rate, (wav * 32767).astype(np.int16))
        lines.append(f"{name}|{d.speakers[i % len(d.speakers)]}|{RUN_TEXTS[i % len(RUN_TEXTS)]}")
    (root / "train.csv").write_text("\n".join(lines[:RUN_TRAIN]) + "\n", encoding="utf-8")
    (root / "val.csv").write_text("\n".join(lines[RUN_TRAIN:]) + "\n", encoding="utf-8")


def check_train_run(card, config_path, seed, root: Path):
    """Phase 8: the training entry point at full CJE width, its resume, and
    the engine serving what it saved; the corpus and the run stay in
    ``root`` for phase 9."""
    import yaml

    from vits_torch.config import load_hparams
    from vits_torch.data.cache_features import main as cache_main
    from vits_torch.data.dataset import DistributedBucketSampler
    from vits_torch.data.preprocess import preprocess_filelist
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops import mas_cuda
    from vits_torch.serve.engine import TTSEngine
    from vits_torch.training.checkpoint import latest_checkpoint
    from vits_torch.training.train import build_dataset, build_discriminator
    from vits_torch.training.train import main as train_main
    from vits_torch.utils.logging_utils import have_matplotlib

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phase 5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    base = yaml.safe_load(Path(config_path).read_text())
    out = {}
    hps0 = load_hparams(config_path)
    write_run_dataset(root, hps0, seed)
    t0 = time.perf_counter()
    for split in ("train", "val"):
        preprocess_filelist(str(root / f"{split}.csv"))
    out["preprocess_s"] = time.perf_counter() - t0
    cfg = dict(base)
    cfg["data"] = dict(base["data"], data_path=str(root),
                       training_files=str(root / "train.clr.csv"),
                       validation_files=str(root / "val.clr.csv"))
    cfg["train"] = dict(base["train"], epochs=2, log_interval=2, eval_interval=2,
                        save_interval=2)
    cfg_path = root / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
    t0 = time.perf_counter()
    cache_main(["-c", str(cfg_path)])
    out["cache_s"] = time.perf_counter() - t0
    hps = load_hparams(str(cfg_path))
    t = hps.train
    val_ds = build_dataset(hps, "val")
    val_batches = len(DistributedBucketSampler(
        val_ds.lengths, min(t.batch_size, len(val_ds)), hps.data.bucket_boundaries,
        shuffle=False))
    print(f"{card} | train run data: {RUN_TRAIN} + {RUN_VAL} synthetic voices of "
          f"{RUN_FRAMES[0]}-{RUN_FRAMES[1]} frames, {len(RUN_TEXTS)} texts, "
          f"{len(hps.data.speakers)} speakers; preprocess {out['preprocess_s']:.2f} s, "
          f"cache_features {out['cache_s']:.2f} s; {val_batches} validation batch(es); "
          f"summaries: tensorboard {importlib.util.find_spec('tensorboard') is not None}, "
          f"matplotlib {have_matplotlib()}")
    model_dir = str(root / "run")

    def train(epochs, label):
        cfg["train"]["epochs"] = epochs
        cfg_path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
        for k in mas_cuda.launches:
            mas_cuda.launches[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = train_main(["-c", str(cfg_path), "-m", model_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(mas_cuda.launches)
        peak = torch.cuda.max_memory_allocated()
        steps = rep.state.step - rep.start_step
        want = mas_only(mas_fused=steps + len(rep.evals) * val_batches)
        print(f"{card} | train run {label}: steps {rep.start_step + 1}-{rep.state.step} "
              f"(epochs {rep.start_epoch}-{epochs - 1}, B={t.batch_size}, bf16 "
              f"{t.bf16_run}, segment {t.segment_size}) in {wall:.2f} s of wall; StepTimer "
              f"intervals " + ", ".join(f"{s * 1e3:.2f}" for s in rep.step_s)
              + " ms (host clock, steps 2 on: a step's interval leaves out evaluate and "
              f"saves and holds an epoch's loader restart); loader waits " + ", ".join(f"{s * 1e3:.2f}" for s in
                                                              rep.data_wait_s)
              + f" ms ({sum(rep.data_wait_s[1:]) / sum(rep.step_s):.4f} of the step "
              f"intervals after the first batch); peak memory {peak / 2**30:.2f} GiB; MAS "
              f"launches {launches}")
        for tag, m in (("first", rep.first_metrics), ("last", rep.last_metrics)):
            print(f"{card} | train run {label} {tag} step: "
                  + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
        for e in rep.evals:
            print(f"{card} | train run {label} evaluate at step {e['step']}: {e['s']:.2f} s, "
                  + ", ".join(f"{k} {v:.5g}" for k, v in e["scalars"].items()))
        for c in rep.checkpoints:
            print(f"{card} | train run {label} checkpoint at step {c['step']}: "
                  f"{c['s']:.2f} s, " + ", ".join(f"{Path(p).name} {b / 2**20:.1f} MiB"
                                                 for p, b in c["bytes"].items()))
        if launches != want:
            raise AssertionError(f"train run {label}: MAS launches {launches}, want {want}")
        if not all(np.isfinite(v) for m in (rep.first_metrics, rep.last_metrics)
                   for v in m.values()):
            raise AssertionError(f"train run {label}: a loss is not finite")
        return rep, dict(wall_s=wall, peak_bytes=peak, launches=launches,
                         step_s=rep.step_s, data_wait_s=rep.data_wait_s,
                         evals=rep.evals, first=rep.first_metrics, last=rep.last_metrics,
                         checkpoints=[dict(step=c["step"], s=c["s"],
                                           bytes=sum(c["bytes"].values()))
                                      for c in rep.checkpoints])

    rep, out["train"] = train(2, "2 epochs")
    out.update(cfg=dict(cfg, train=dict(cfg["train"])), val_batches=val_batches,
               losses=logged_losses(Path(model_dir) / "train.log"))
    if rep.start_step != 0 or rep.state.step != 4 or len(rep.evals) != 2 \
            or len(rep.checkpoints) != 2:
        raise AssertionError(f"train run: steps {rep.start_step}-{rep.state.step}, "
                             f"{len(rep.evals)} evaluations, {len(rep.checkpoints)} saves")
    torch.manual_seed(t.seed)  # the run's initial weights
    init = [p for m in (build_synthesizer(hps, bf16=t.bf16_run),
                        build_discriminator(hps, t.bf16_run, "cuda"))
            for p in m.parameters()]
    moved = [not torch.equal(a, p.detach()) for a, p in zip(
        init, (p for m in (rep.state.model, rep.state.disc) for p in m.parameters()))]
    print(f"{card} | train run: {sum(moved)} of {len(moved)} parameter tensors moved")
    if not all(moved):
        raise AssertionError(f"train run: {len(moved) - sum(moved)} tensors never moved")
    del rep, init
    torch.cuda.empty_cache()

    rep, out["resume"] = train(3, "resumed to 3 epochs")
    # the saved epoch (1) runs again: steps 5-8 over epochs 1 and 2
    if rep.start_step != 4 or rep.start_epoch != 1 or rep.state.step != 8:
        raise AssertionError(f"resume: from step {rep.start_step} epoch "
                             f"{rep.start_epoch} to step {rep.state.step}")
    trained = {k: v.detach().clone() for k, v in rep.state.model.state_dict().items()}
    del rep
    torch.cuda.empty_cache()

    newest = latest_checkpoint(model_dir, "eval")
    eng = TTSEngine(str(cfg_path), checkpoint_path=newest, max_frames=1000)
    same = all(torch.equal(v, trained[k]) for k, v in eng.model.state_dict().items())
    text = RUN_TEXTS[4]
    ms, (_, (rate, audio)) = wall_stats(lambda: eng.synthesize(text, 1, seed=seed), n=3)
    _, (_, chunked) = eng.synthesize_chunked(text, 1, seed=seed)
    hop = hps.data.hop_length
    print(f"{card} | train run serve {Path(newest).name}: strict load, weights equal to the "
          f"trained generator: {same}; synthesize {text!r}: {len(audio) / rate:.3f} s of "
          f"audio, median {ms[0]:.2f} ms (n=3), length equal to synthesize_chunked: "
          f"{len(audio) == len(chunked)}")
    if not same or audio.ndim != 1 or not 0 < len(audio) < 1000 * hop \
            or len(audio) % hop or len(audio) != len(chunked) or not np.isfinite(audio).all():
        raise AssertionError("train run: the engine does not serve the saved generator")
    out["serve_ms"] = ms
    del eng, trained
    torch.cuda.empty_cache()
    return out


def logged_losses(log: Path) -> dict[int, tuple[float, float]]:
    """{step: (g, d)} of a run's train.log, each step's first line."""
    out = {}
    for line in log.read_text().splitlines():
        msg = line.split("\t")[-1]
        if msg.startswith("step ") and " | g " in msg:
            step, rest = msg[5:].split(" | g ")
            g, d = rest.split(" d ")
            out.setdefault(int(step), (float(g), float(d)))
    return out


def processes_naming(text: str) -> dict[int, str]:
    """{pid: command line} of live processes whose command line holds text
    (torchrun starts its ranks in sessions of their own, and loader workers
    carry their rank's command line)."""
    found = {}
    for cmd in Path("/proc").glob("[0-9]*/cmdline"):
        try:
            line = cmd.read_bytes().replace(b"\0", b" ").decode()
            state = (cmd.parent / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except (OSError, IndexError):
            continue
        if text in line and state != "Z" and int(cmd.parent.name) != os.getpid():
            found[int(cmd.parent.name)] = line
    return found


# phase 8's losses agreed to 4-5 digits across repeated runs on an H100
# (cuDNN's algorithms are not bitwise deterministic); the log keeps 4
# decimals of losses of ~1e0-1e2
DDP_CLI_RTOL = 1e-3


def check_ddp_cli(card, root: Path, run: dict):
    """Phase 9 (a): torchrun --nproc_per_node 1 ... --distributed at full
    width over NCCL on phase 8's corpus; the same losses as phase 8."""
    import yaml

    from vits_torch.serve.engine import TTSEngine

    cfg = dict(run["cfg"], train=dict(run["cfg"]["train"], epochs=2))
    cfg_path = root / "ddp.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, allow_unicode=True))
    model_dir = root / "ddp_run"
    # --local-addr: the rank meets torchrun's agent on the loopback device, not at
    # whatever the host's name resolves to
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--local-addr",
           "127.0.0.1", "--nproc_per_node", "1", "-m", "vits_torch.training.train", "-c",
           str(cfg_path), "-m", str(model_dir), "--distributed"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    left = processes_naming(str(model_dir))
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    if proc.returncode != 0:
        raise AssertionError(f"ddp cli: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    if left:
        raise AssertionError(f"ddp cli: processes left running (now killed): {left}")
    log = (model_dir / "train.log").read_text()
    done = [ln.split("\t")[-1] for ln in log.splitlines() if "\trun done at step" in ln]
    launches = json.loads(done[0].split("kernel launches in this process ")[1]
                          .split(";")[0].replace("'", '"'))
    peak_gib = float(done[0].split("peak device memory ")[1].split(" GiB")[0])
    intervals = [float(v) for v in done[0].split("step intervals ")[1].split(" ms")[0]
                 .split(", ")]
    losses = logged_losses(model_dir / "train.log")
    ref = run["losses"]
    errs = {s: (abs(losses[s][0] - ref[s][0]) / abs(ref[s][0]),
                abs(losses[s][1] - ref[s][1]) / abs(ref[s][1])) for s in (2, 4)}
    want = 4 + 2 * run["val_batches"]
    print(f"{card} | ddp cli torchrun --nproc_per_node 1 --distributed (NCCL, world 1), phase 8's "
          f"corpus and config, B={cfg['train']['batch_size']}, 2 epochs: exit 0 in {wall:.2f} s of "
          f"wall (process start, build, data, 4 steps, 2 evaluations, 2 saves); StepTimer "
          f"intervals " + ", ".join(f"{v:.2f}" for v in intervals) + f" ms; peak memory "
          f"{peak_gib:.2f} GiB; MAS launches {launches} (want mas_fused {want}); no process "
          f"left")
    for s in (2, 4):
        print(f"{card} | ddp cli step {s}: g {losses[s][0]:.4f} d {losses[s][1]:.4f}; phase 8 "
              f"g {ref[s][0]:.4f} d {ref[s][1]:.4f}; relative difference g {errs[s][0]:.3e} "
              f"d {errs[s][1]:.3e} (tolerance rtol {DDP_CLI_RTOL})")
    if launches != mas_only(mas_fused=want):
        raise AssertionError(f"ddp cli: MAS launches {launches}, want mas_fused {want}")
    if any(e > DDP_CLI_RTOL for pair in errs.values() for e in pair):
        raise AssertionError("ddp cli: losses differ from phase 8's")
    eng = TTSEngine(str(cfg_path), checkpoint_path=str(model_dir / "eval_4"), max_frames=1000)
    _, (rate, audio) = eng.synthesize(RUN_TEXTS[4], 1, seed=0)
    if audio.ndim != 1 or not 0 < len(audio) < 1000 * eng.hop or not np.isfinite(audio).all():
        raise AssertionError("ddp cli: the engine does not serve eval_4")
    print(f"{card} | ddp cli serve eval_4: strict load, {len(audio) / rate:.3f} s of audio")
    del eng
    torch.cuda.empty_cache()
    return dict(wall_s=wall, peak_gib=peak_gib, launches=launches, step_ms=intervals,
                losses={s: losses[s] for s in (2, 4)}, rel_err=errs)


DDP_X_LENGTHS, DDP_SPEC_LENGTHS = [9, 9, 4, 3], [16, 16, 9, 8]  # rank 0 long, rank 1 short


def tiny_ddp_setup(seed, payload: Path):
    """Phase 6's tiny configuration at a global batch of 4 with unequal
    lengths, its global noise and initial weights, written to ``payload``
    for the ranks. Returns (hps, payload dict)."""
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.models.avocodo import probe_discriminator
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.ops.phaseaug import sample_phi

    hps = tiny_hps()
    rng = np.random.default_rng(seed + 9)
    b, t_x, t_y = 4, 9, 16
    batch = {
        "x": rng.integers(1, 30, (b, t_x)), "t": rng.integers(0, 6, (b, t_x)),
        "x_lengths": np.array(DDP_X_LENGTHS), "spec_lengths": np.array(DDP_SPEC_LENGTHS),
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
    torch.manual_seed(seed)
    model = SynthesizerTrn(**TINY_TRAIN, device="cpu")
    disc = probe_discriminator(segment_size=2048, device="cpu")
    data = {"g": model.state_dict(), "d": disc.state_dict(), "batch": batch, "noise": noise}
    torch.save(data, payload)
    return hps, data


def tiny_card_state(data, hps):
    """The tiny models on the card from ``data``'s weights, dropout off, TF32
    off, cuDNN deterministic (phase 6's settings)."""
    from vits_torch.models.avocodo import probe_discriminator
    from vits_torch.models.synthesizer import SynthesizerTrn
    from vits_torch.training.step import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = SynthesizerTrn(**TINY_TRAIN, device="cuda")
    model.load_state_dict(data["g"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    disc = probe_discriminator(segment_size=2048, device="cuda")
    disc.load_state_dict(data["d"])
    return create_train_state(model, disc, hps, steps_per_epoch=10)


def state_arrays(state) -> dict:
    return {side: {k: (p.detach().cpu().numpy(), p.grad.cpu().numpy())
                   for k, p in getattr(state, side).named_parameters()}
            for side in ("model", "disc")}


def hold_step(metrics, state, m_one, s_one, initial, lr):
    """One step's metrics and its {side: {name: (param, grad)}} against one
    process's on the same global batch: metrics rtol 1e-4; gradients within
    1e-3 (decoder 1e-2) of the tensor's norm + 1e-6 of the global norm;
    updated parameters within 1e-3 of the update's norm where the gradient's
    sign is settled, 2.01 x lr elsewhere. Returns (failures, worst errors,
    settled elements, elements)."""
    bad = [k for k in m_one if abs(metrics[k] - m_one[k]) > 1e-4 * abs(m_one[k])]
    worst = {"grad": 0.0, "settled": 0.0, "rest": 0.0}
    n_settled = n_all = 0
    for side in ("model", "disc"):
        total = m_one[f"grad_norm/{'g' if side == 'model' else 'd'}"]
        start = initial["g" if side == "model" else "d"]
        for k, (p_ref, g_ref) in s_one[side].items():
            p, g = state[side][k]
            g_err = float(np.linalg.norm(g - g_ref))
            rel = 1e-2 if k.startswith("waveform_decoder.") else 1e-3
            g_tol = rel * float(np.linalg.norm(g_ref)) + 1e-6 * total
            if g_err > 1e-6 * total:
                worst["grad"] = max(worst["grad"], g_err / float(np.linalg.norm(g_ref)))
            if g_err > g_tol:
                bad.append(f"grad {side}.{k}")
            # Adam's first step moves an element by lr * g / (|g| + eps): +-lr
            # where the gradient's sign is settled (|g_ref| above the tensor's
            # gradient tolerance, which no passing gradient can cross), any
            # value in [-lr, lr] where it is ~0. Settled elements must take the
            # reference's update within 1e-3 of its norm; the rest 2.01 x lr.
            settled = np.abs(g_ref) > g_tol
            n_settled, n_all = n_settled + int(settled.sum()), n_all + settled.size
            if settled.any():
                p0 = start[k].numpy()
                err = float(np.linalg.norm((p - p_ref)[settled])
                            / np.linalg.norm((p_ref - p0)[settled]))
                worst["settled"] = max(worst["settled"], err)
                if err > 1e-3:
                    bad.append(f"param {side}.{k} (settled)")
            if not settled.all():
                err = float(np.abs(p - p_ref)[~settled].max())
                worst["rest"] = max(worst["rest"], err)
                if err > 2.01 * lr:
                    bad.append(f"param {side}.{k}")
    return bad, worst, n_settled, n_all


def ddp_rank_step(payload: str) -> dict:
    """Phase 9 (b), one rank (a spawned process): its rows of the global
    batch, one DDP train_step on the card; metrics, parameters, gradients and
    this process's MAS launches."""
    from vits_torch.graft_entry import tiny_hps
    from vits_torch.ops import mas_cuda
    from vits_torch.parallel import mesh
    from vits_torch.training.step import replicate_state, train_step

    hps = tiny_hps()
    data = torch.load(payload, weights_only=False)
    state = replicate_state(tiny_card_state(data, hps), hps)
    rows = mesh.rank_rows(data["batch"], mesh.process_index(), mesh.process_count(), 4)
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    metrics = train_step(state, rows, hps, noise=data["noise"])
    torch.cuda.synchronize()
    launches = dict(mas_cuda.launches)
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "state": state_arrays(state),
            "launches": launches}


def check_ddp_two_ranks(card, root: Path, seed):
    """Phase 9 (b): two ranks on the one card over gloo against one process
    on the global batch."""
    from vits_torch.parallel import mesh
    from vits_torch.training.step import train_step

    payload = root / "ddp_tiny.pt"
    hps, data = tiny_ddp_setup(seed, payload)
    t0 = time.perf_counter()
    ranks = mesh.spawn(ddp_rank_step, 2, str(payload), device="cuda:0", backend="gloo",
                       timeout=300)
    wall = time.perf_counter() - t0
    one = tiny_card_state(data, hps)
    m_one = {k: v.item() for k, v in train_step(one, data["batch"], hps,
                                                noise=data["noise"]).items()}
    s_one = state_arrays(one)
    got = ranks[0]
    bad, worst, n_settled, n_all = hold_step(got["metrics"], got["state"], m_one, s_one,
                                             data, hps.train.learning_rate)
    if ranks[1]["metrics"] != got["metrics"]:
        bad.append("the ranks' metrics differ")
    for side in ("model", "disc"):
        for k, (p, _) in got["state"][side].items():
            if not (np.array_equal(p, ranks[1]["state"][side][k][0])):
                bad.append(f"rank 1 {side}.{k} differs from rank 0")
    lr = hps.train.learning_rate
    launches = [r["launches"] for r in ranks]
    print(f"{card} | ddp two ranks on the card over gloo (spawned, joined in {wall:.2f} s), tiny "
          f"config + probe D, global batch 4 (x_lengths {DDP_X_LENGTHS}, spec_lengths "
          f"{DDP_SPEC_LENGTHS}: rank 0 long, rank 1 short), TF32 off, cuDNN deterministic, "
          f"against one process on the global batch: max relative metric error "
          f"{max(abs(got['metrics'][k] - m_one[k]) / abs(m_one[k]) for k in m_one):.3e} "
          f"(rtol 1e-4); gradients, worst relative error above 1e-6 of the global norm "
          f"{worst['grad']:.3e} (1e-3, decoder 1e-2, of the tensor's norm); updated parameters "
          f"on the {n_settled} of {n_all} elements whose gradient sign is settled, worst "
          f"||err|| {worst['settled']:.3e} of the update's norm per tensor (1e-3), elsewhere "
          f"max|err| {worst['rest']:.3e} (2.01 x lr = {2.01 * lr:.2e}); the ranks' parameters "
          f"equal; MAS launches per rank {launches}")
    if bad:
        raise AssertionError(f"ddp two ranks: {bad[:10]}")
    if any(ln != mas_only(mas_fused=1) for ln in launches):
        raise AssertionError(f"ddp two ranks: MAS launches {launches}, want mas_fused 1 a rank")
    return dict(wall_s=wall, launches=launches, worst=worst)


def check_entry_and_host_mas(card, main_lengths):
    """Phase 9, last part: graft_entry.entry() and dryrun_multichip(2) on
    the card; the host MAS against the plain version at the main-path
    shape."""
    from vits_torch import graft_entry
    from vits_torch.ops import mas, mas_native

    fn, args = graft_entry.entry()
    wav = fn(*args)
    torch.cuda.synchronize()
    ms = host_ms(lambda: fn(*args), iters=5)
    if tuple(wav.shape) != (1, 256 * 256, 1) or not torch.isfinite(wav).all() \
            or args[0].device.type != "cuda":
        raise AssertionError(f"graft_entry.entry(): wav {tuple(wav.shape)} on {wav.device}")
    print(f"{card} | graft_entry.entry() on {wav.device}: wav {tuple(wav.shape)}, median "
          f"{ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n=5; host clock)")
    del fn, args, wav
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(2)  # its default device: the card
    wall = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in dry.values()):
        raise AssertionError(f"graft_entry.dryrun_multichip(2): {dry}")
    print(f"{card} | graft_entry.dryrun_multichip(2): two gloo ranks on cuda:0 (spawned, "
          f"joined), one DDP step of the tiny model, {wall:.2f} s of wall")
    neg, mask, _, _ = mas_case(MAIN_B, MAIN_T_Y, MAIN_T_X, 7, *main_lengths)
    ref = mas.maximum_path_torch(neg, mask).cpu().numpy()
    neg_np, mask_np = neg.cpu().numpy(), mask.cpu().numpy()
    out = mas_native.maximum_path_native(neg_np, mask_np)
    ms_native = host_ms(lambda: mas_native.maximum_path_native(neg_np, mask_np))
    err = float(np.abs(out - ref).max())
    print(f"{card} | host MAS (g++ -O3 -fopenmp, {os.cpu_count()} cores) B={MAIN_B} "
          f"T_y={MAIN_T_Y} T_x={MAIN_T_X} main-path lengths: max|err| {err} against "
          f"maximum_path_torch; median {ms_native[0]:.3f} ms (min {ms_native[1]:.3f}, max "
          f"{ms_native[2]:.3f}, n=10; host clock)")
    if err:
        raise AssertionError("host MAS disagrees with the plain version")
    return dict(entry_ms=ms, host_mas_ms=ms_native)


TP_MESH, TP_ROWS = (2, 2), 2  # phase 10: a 2 x 2 (data, model) mesh, 2 rows a data rank


def tp_setup(hps, batch, seed, payload: Path) -> dict:
    """Phase 10's inputs, written to ``payload`` for the ranks: the CJE
    generator and the flagship discriminator from the seed, the first
    2 x TP_ROWS rows of phase 3's batch, and the global batch's draws."""
    from vits_torch.models.avocodo import AvocodoDiscriminator
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops.phaseaug import sample_phi

    rows = TP_MESH[0] * TP_ROWS
    torch.manual_seed(seed + 10)
    model = build_synthesizer(hps, device="cpu")
    disc = AvocodoDiscriminator(segment_size=hps.train.segment_size, device="cpu")
    b = {k: v[:rows].cpu() for k, v in batch.items()}
    tb = dict(x=b["x"], t=b["t"], x_lengths=b["x_lengths"], spec=b["y"],
              spec_lengths=b["y_lengths"], ying=b["ying"], wav=b["wav"], sid=b["sid"])
    gen = torch.Generator().manual_seed(seed + 10)
    noise = model.draw_noise(rows, tb["x"].shape[1], tb["spec"].shape[1], gen)
    noise.update(phi_d=sample_phi(2 * rows, gen), phi_g=sample_phi(2 * rows, gen))
    data = {"g": model.state_dict(), "d": disc.state_dict(), "batch": tb, "noise": noise}
    torch.save(data, payload)
    return data


def tp_card_state(data, hps, mesh_2d=None):
    """Phase 10's models on this process's card from ``data``'s weights, f32,
    dropout off, TF32 off, deterministic kernels (model peers compute their
    replicas independently, and must get the same bits); the decoder split
    over ``mesh_2d``'s model group when one is given."""
    from vits_torch.models.avocodo import AvocodoDiscriminator
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.parallel import mesh
    from vits_torch.training.step import create_train_state, replicate_state

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    model = build_synthesizer(hps)  # on the process's current card
    model.load_state_dict(data["g"])
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    disc = AvocodoDiscriminator(segment_size=hps.train.segment_size)
    disc.load_state_dict(data["d"])
    if mesh_2d is not None:
        mesh.tp_shard_generator(model, mesh_2d)
    state = create_train_state(model, disc, hps, steps_per_epoch=100)
    return replicate_state(state, hps) if mesh_2d is not None else state


def tp_rank_step(payload: str, out: str, config_path: str) -> dict:
    """Phase 10, one rank (a spawned process): the 2 x 2 mesh, its data
    row's rows, one train_step with the decoder split; its wall, peak
    memory, MAS launches and a digest of every replicated parameter. Rank 0
    also saves the gathered parameters and gradients to ``out``."""
    import hashlib

    from vits_torch.config import load_hparams
    from vits_torch.ops import mas_cuda
    from vits_torch.parallel import mesh
    from vits_torch.training.step import train_step

    hps = load_hparams(config_path)
    m = mesh.make_mesh_2d(*TP_MESH)
    data = torch.load(payload, weights_only=False)
    state = tp_card_state(data, hps, m)
    rows = mesh.rank_rows(data["batch"], m.data_index, m.n_data, m.n_data * TP_ROWS)
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = train_step(state, rows, hps, noise=data["noise"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mas_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    gathered = {}
    for side, module in (("model", state.model), ("disc", state.disc)):
        params = mesh.gather_state_dict(module, m) if side == "model" else module.state_dict()
        gathered[side] = {}
        for k, p in module.named_parameters():
            dim = getattr(p, "tp_dim", None)
            g = p.grad if dim is None else mesh._all_gather_cat(p.grad, dim, m.model_group,
                                                                 m.n_model)
            gathered[side][k] = (params[k].cpu().numpy(), g.cpu().numpy())
    digests = {k: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
               for module in (state.model, state.disc) for k, p in module.named_parameters()
               if getattr(p, "tp_dim", None) is None}
    if mesh.process_index() == 0:
        torch.save(gathered, out)
    split = sorted(k for k, p in state.model.named_parameters()
                   if getattr(p, "tp_dim", None) is not None)
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "wall_s": wall,
            "peak_bytes": peak, "launches": launches, "digests": digests, "split": split,
            "place": (m.data_index, m.model_index)}


def check_tp(card, config_path, batch, root: Path, seed):
    """Phase 10: dryrun_multichip_2d(4) on the card, then one 2-D step at
    full width over four gloo ranks on cuda:0 against one process on the
    global batch with the same draws."""
    from vits_torch import graft_entry
    from vits_torch.config import load_hparams
    from vits_torch.parallel import mesh
    from vits_torch.training.step import train_step

    hps = load_hparams(config_path)

    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip_2d(4)  # its default device: the card
    dry_s = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in dry.values()):
        raise AssertionError(f"graft_entry.dryrun_multichip_2d(4): {dry}")
    print(f"{card} | graft_entry.dryrun_multichip_2d(4): four gloo ranks on cuda:0 (2 x 2 "
          f"mesh), one step of the tiny model, {dry_s:.2f} s of wall")

    payload, out = root / "tp_full.pt", root / "tp_rank0.pt"
    data = tp_setup(hps, batch, seed, payload)
    world = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    ranks = mesh.spawn(tp_rank_step, world, str(payload), str(out), config_path,
                       device="cuda:0", backend="gloo", timeout=900)
    wall = time.perf_counter() - t0
    one = tp_card_state(data, hps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    m_one = {k: v.item() for k, v in train_step(one, data["batch"], hps,
                                                noise=data["noise"]).items()}
    torch.cuda.synchronize()
    one_s, one_peak = time.perf_counter() - t1, torch.cuda.max_memory_allocated()
    s_one = state_arrays(one)
    del one
    torch.cuda.empty_cache()
    got = torch.load(out, weights_only=False)
    bad, worst, n_settled, n_all = hold_step(ranks[0]["metrics"], got, m_one, s_one, data,
                                             hps.train.learning_rate)
    if [r["place"] for r in ranks] != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        bad.append(f"mesh places {[r['place'] for r in ranks]}")
    if any(r["metrics"] != ranks[0]["metrics"] for r in ranks):
        bad.append("the ranks' metrics differ")
    peers = [k for d in range(TP_MESH[0]) for k, h in ranks[2 * d]["digests"].items()
             if ranks[2 * d + 1]["digests"][k] != h]
    if peers:
        bad.append(f"model peers' replicas differ: {peers[:5]} ({len(peers)} tensors)")
    launches = [r["launches"] for r in ranks]
    rel = max(abs(ranks[0]["metrics"][k] - m_one[k]) / abs(m_one[k]) for k in m_one)
    print(f"{card} | tp 2 x 2 mesh (data, model), four gloo ranks on cuda:0 (spawned, joined "
          f"in {wall:.2f} s), CJE generator at full width + flagship Avocodo D, f32, TF32 off, "
          f"deterministic kernels, {TP_ROWS} rows a data rank (global batch "
          f"{TP_MESH[0] * TP_ROWS}, T_y {data['batch']['spec'].shape[1]}, T_x "
          f"{data['batch']['x'].shape[1]}), segment {hps.train.segment_size}: "
          f"{len(ranks[0]['split'])} decoder tensors split on output channels; against one "
          f"process on the global batch: max relative metric error {rel:.3e} (rtol 1e-4); "
          f"gradients, worst relative error above 1e-6 of the global norm {worst['grad']:.3e} "
          f"(1e-3, decoder 1e-2, of the tensor's norm); updated parameters on the {n_settled} "
          f"of {n_all} elements whose gradient sign is settled, worst ||err|| "
          f"{worst['settled']:.3e} of the update's norm per tensor (1e-3), elsewhere max|err| "
          f"{worst['rest']:.3e} (2.01 x lr); model peers' replicated parameters "
          f"{'equal bit for bit' if not peers else 'DIFFER'}; MAS launches per rank {launches}")
    print(f"{card} | tp step wall per rank "
          + ", ".join(f"{r['wall_s'] * 1e3:.2f} ms" for r in ranks)
          + "; peak memory per rank "
          + ", ".join(f"{r['peak_bytes'] / 2**30:.2f} GiB" for r in ranks)
          + f"; one process on the global batch {one_s * 1e3:.2f} ms, "
          f"{one_peak / 2**30:.2f} GiB (host clock, synchronized; first step of each process)")
    if bad:
        raise AssertionError(f"tp: {bad[:10]}")
    if any(ln != mas_only(mas_fused=1) for ln in launches):
        raise AssertionError(f"tp: MAS launches {launches}, want mas_fused 1 a rank")
    return dict(launches=launches, worst=worst, wall_s=[r["wall_s"] for r in ranks],
                peak_bytes=[r["peak_bytes"] for r in ranks], dryrun_s=dry_s)


CONV_EPOCHS, CONV_INTERVAL = 2, 16  # phase 11: 2 epochs of the study, a checkpoint every 16 steps


def check_convergence_tool(card, root: Path, model=None):
    """Phase 11: tools/convergence_torch.py's gen, train, analyze and synth
    on the card at the study's configuration, for 2 epochs with evaluations
    and checkpoints every 16 steps. It shows the tool runs on the card, not
    that the model converges. ``model`` overrides the study's model
    entries (a rehearsal's tiny widths)."""
    from vits_torch.config import load_hparams
    from vits_torch.data.dataset import DistributedBucketSampler
    from vits_torch.ops import mas_cuda
    from vits_torch.training.train import build_dataset

    spec = importlib.util.spec_from_file_location("convergence_torch",
                                                  ROOT / "tools" / "convergence_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    work = str(root / "conv")
    t0 = time.perf_counter()
    tool.gen(work)
    gen_s = time.perf_counter() - t0
    cfg = tool.make_config(work, CONV_EPOCHS, model=model, train={
        "eval_interval": CONV_INTERVAL, "save_interval": CONV_INTERVAL})
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = tool.train(work, CONV_EPOCHS, config=cfg)
    train_s = time.perf_counter() - t0
    launches = dict(mas_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    rows = tool.analyze(work)
    summary = tool.synth(work)
    rest_s = time.perf_counter() - t0
    steps = report.state.step
    ms = [t * 1e3 for t in report.step_s]
    print(f"{card} | convergence tool: gen {gen_s:.2f} s (280 voices); train {steps} steps at "
          f"the study's config (B=16, upsample_initial_channel 256, n_layers 4, bf16) in "
          f"{train_s:.2f} s: StepTimer intervals median {np.median(ms):.2f} ms (min "
          f"{min(ms):.2f}, max {max(ms):.2f}, n={len(ms)}), loader waits "
          f"{sum(report.data_wait_s):.2f} s over {len(report.data_wait_s)} batches, peak "
          f"{peak / 2**30:.2f} GiB; loss/g/total {report.first_metrics['loss/g/total']:.4f} -> "
          f"{report.last_metrics['loss/g/total']:.4f}; MAS launches {launches}; analyze + "
          f"synth {rest_s:.2f} s")
    for r in rows:
        print(f"{card} | convergence tool analyze: " + json.dumps(r))
    print(f"{card} | convergence tool synth: " + json.dumps(summary))
    evals = len(report.evals)
    hps = load_hparams(cfg)
    val_ds = build_dataset(hps, "val")
    val_batches = evals * len(DistributedBucketSampler(
        val_ds.lengths, min(hps.train.batch_size, len(val_ds)), hps.data.bucket_boundaries,
        num_replicas=1, rank=0, shuffle=False))
    if steps != len(report.data_wait_s) or not all(
            np.isfinite(list(report.last_metrics.values()))):
        raise AssertionError(f"convergence tool: {steps} steps, {report.last_metrics}")
    if [r["step"] for r in rows] != [CONV_INTERVAL * (i + 1) for i in range(evals)] or not all(
            np.isfinite(r[k]) for r in rows for k in ("dur_loss", "mas_boundary_mae")):
        raise AssertionError(f"convergence tool: analyze {rows}")
    if summary["n"] != 8 or not np.isfinite(summary["mean_sim"]):
        raise AssertionError(f"convergence tool: synth {summary}")
    if launches != mas_only(mas_fused=steps + val_batches):
        raise AssertionError(f"convergence tool: MAS launches {launches}, want one a train "
                             f"step and one a validation batch ({steps} + {val_batches})")
    return dict(launches=launches, step_ms=ms, steps=steps)


MIGRATE_STEP = 200000  # phase 13: the step in the reference pair's file names
MIGRATE_WARMUP, MIGRATE_TIMED = 1, 3  # phase 13: fine-tune steps
# phase 13: entries of the reference pair that the converter must drop (the
# reference Avocodo keeps PQMF filter buffers in its state_dict)
MIGRATE_G_EXTRA = {"unread_buffer": torch.arange(5.0)}
MIGRATE_D_EXTRA = {"combd.pqmf_list.0.analysis_filter": torch.ones(4, 1, 193),
                   "sbd.pqmf.analysis_filter": torch.ones(16, 1, 257)}


def check_migration(card, config_path, batch, seed, root: Path):
    """Phase 13: a reference (Aloento/VITS) checkpoint pair at full CJE width
    through the converter's command line, served and fine-tuned."""
    from vits_torch.config import load_hparams
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops import mas_cuda
    from vits_torch.serve.engine import TTSEngine
    from vits_torch.training.checkpoint import load_eval_params, merge_compatible
    from vits_torch.training.step import create_train_state, train_step
    from vits_torch.training.train import build_discriminator

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phases 5 and 7
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    hps = load_hparams(config_path)
    torch.manual_seed(seed)
    src_g = {k: v.detach().clone() for k, v in build_synthesizer(hps).state_dict().items()}
    src_d = {k: v.detach().clone() for k, v in
             build_discriminator(hps, False, "cuda").state_dict().items()}
    opt = torch.optim.AdamW([torch.zeros(3, requires_grad=True)],
                            lr=hps.train.learning_rate).state_dict()
    eval_pth = root / f"Model_Eval_{MIGRATE_STEP}.pth"
    train_pth = root / f"Model_Train_{MIGRATE_STEP}.pth"
    # the reference's format under DDP: module.-prefixed keys, tensors on the card
    torch.save({"model_g": {"module." + k: v for k, v in {**src_g, **MIGRATE_G_EXTRA}.items()},
                "iteration": MIGRATE_STEP, "learning_rate": hps.train.learning_rate}, eval_pth)
    torch.save({"model_d": {"module." + k: v for k, v in {**src_d, **MIGRATE_D_EXTRA}.items()},
                "optimizer": opt, "iteration": MIGRATE_STEP}, train_pth)
    out_dir = root / "migrated"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vits_torch.utils.convert_reference", str(eval_pth),
         "--out-dir", str(out_dir), "--train-pth", str(train_pth)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    cli_s = time.perf_counter() - t0
    eval_path = out_dir / f"eval_{MIGRATE_STEP}"
    disc_path = out_dir / f"disc_{MIGRATE_STEP}"
    print(f"{card} | migrate: {eval_pth.name} {eval_pth.stat().st_size / 2**20:.1f} MiB + "
          f"{train_pth.name} {train_pth.stat().st_size / 2**20:.1f} MiB (module.-prefixed, "
          f"one unread entry in G, two in D) -> python -m vits_torch.utils.convert_reference: "
          f"exit {proc.returncode} in {cli_s:.2f} s of wall; "
          + "; ".join(proc.stderr.strip().splitlines()[-2:]))
    if proc.returncode != 0 or proc.stdout.strip().splitlines()[-1:] != [f"wrote {eval_path}"] \
            or not disc_path.is_file():
        raise AssertionError(f"migrate: the converter failed\n{proc.stdout}\n{proc.stderr}")

    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    eng = TTSEngine(config_path, checkpoint_path=str(eval_path), max_frames=1000)
    got = eng.model.state_dict()
    same = list(got) == list(src_g) and all(torch.equal(got[k], v) for k, v in src_g.items())
    ref = TTSEngine(config_path, max_frames=1000)
    ref.model.load_state_dict(src_g)
    worst_rel, lengths_equal, out = 0.0, True, {}
    for i, (lang, text) in enumerate(SERVE_TEXTS.items()):
        if lang == "long":
            continue
        ms, (_, (_, audio)) = wall_stats(
            lambda: eng.synthesize(text, speaker_id=i % 5, seed=seed + i), n=3)
        want = ref.synthesize(text, speaker_id=i % 5, seed=seed + i)[1][1]
        if len(audio) != len(want) or not np.isfinite(audio).all():
            lengths_equal = False
            continue
        rel = float(np.abs(audio - want).max()) / max(float(np.abs(want).max()), 1e-12)
        worst_rel = max(worst_rel, rel)
        out[lang] = dict(ms=ms, audio_s=len(audio) / eng.sampling_rate, rel_err=rel)
        print(f"{card} | migrate serve {lang}: {len(audio) / eng.sampling_rate:.3f} s of "
              f"audio, median {ms[0]:.2f} ms (n=3; host clock); against the source state "
              f"dict's engine: max|err| {rel:.3e} of its peak")
    serve_launches = dict(mas_cuda.launches)
    print(f"{card} | migrate serve eval_{MIGRATE_STEP}: strict load, state_dict equal to the "
          f"source generator bit for bit: {same}; lengths equal: {lengths_equal}, worst "
          f"{worst_rel:.3e} of the peak (tolerance {BATCH_VS_SOLO_REL}); MAS launches "
          f"{serve_launches}")
    if not same or not lengths_equal or worst_rel > BATCH_VS_SOLO_REL \
            or any(serve_launches.values()):
        raise AssertionError("migrate: the engine does not serve the migrated generator")
    del eng, ref, got, src_g, src_d
    torch.cuda.empty_cache()

    bf16 = bool(hps.train.bf16_run)
    model = build_synthesizer(hps, bf16=bf16)
    disc = build_discriminator(hps, bf16, "cuda")
    merged = {}
    for side, m, loaded in (
        ("G", model, load_eval_params(str(eval_path), "cuda")),
        ("D", disc, torch.load(disc_path, map_location="cuda", weights_only=True)["d_params"]),
    ):
        sd, used, skipped = merge_compatible(m.state_dict(), loaded)
        merged[side] = (used, skipped)
        if used != len(loaded) or skipped:
            raise AssertionError(f"migrate: merge_compatible of {side} used {used} of "
                                 f"{len(loaded)}, skipped {skipped}")
        m.load_state_dict(sd)
    del sd, loaded
    torch.cuda.empty_cache()
    state = create_train_state(model, disc, hps, steps_per_epoch=100)
    start = [p.detach().clone() for m in (model, disc) for p in m.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = batch
    tb = dict(x=b["x"], t=b["t"], x_lengths=b["x_lengths"], spec=b["y"],
              spec_lengths=b["y_lengths"], ying=b["ying"], wav=b["wav"], sid=b["sid"])
    n = MIGRATE_WARMUP + MIGRATE_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    times, metrics = [], []
    for i in range(n):
        t0 = time.perf_counter()
        m = train_step(state, tb, hps, generator=gen)
        torch.cuda.synchronize()
        if i >= MIGRATE_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    tune_launches = dict(mas_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    moved = [not torch.equal(a, p.detach())
             for a, p in zip(start, (p for m in (model, disc) for p in m.parameters()))]
    ms = (float(np.median(times)), min(times), max(times))
    print(f"{card} | migrate fine-tune: merge_compatible G used {merged['G'][0]} skipped "
          f"{merged['G'][1]}, D used {merged['D'][0]} skipped {merged['D'][1]}; bf16 "
          f"{bf16}, B={MAIN_B} T_y={MAIN_T_Y} segment {hps.train.segment_size}: median "
          f"{ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n={MIGRATE_TIMED} after "
          f"{MIGRATE_WARMUP} warm-up; host clock, synchronized) "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms; peak memory {peak / 2**30:.2f} GiB; {sum(moved)} of {len(moved)} "
          f"parameter tensors moved; launches in {n} steps {tune_launches}")
    for tag, m in (("first", metrics[0]), ("last", metrics[-1])):
        print(f"{card} | migrate fine-tune {tag} step: "
              + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    if tune_launches != mas_only(mas_fused=n):
        raise AssertionError("migrate fine-tune: mas_fused must launch once a step")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("migrate fine-tune: a loss is not finite")
    if not all(moved):
        raise AssertionError(f"migrate fine-tune: {len(moved) - sum(moved)} tensors never moved")
    del state, model, disc, start
    torch.cuda.empty_cache()
    return dict(cli_s=cli_s, serve=out, step_ms=ms, peak_bytes=peak,
                launches={name: {"serve": serve_launches[name], "fine_tune": tune_launches[name]}
                          for name in serve_launches})


LONG_B, LONG_MAX_TEXT_LEN = 16, 510  # phase 14: T_x = 2 * 510 + 4 = 1024
LONG_WARMUP, LONG_TIMED = 1, 3


def check_long_text(card, config_path, seed):
    """Phase 14: long texts at full CJE width. configs/config_cje.yaml with
    max_text_len 510 (the train CLI's text bound, 1024 columns) at its top
    bucket (1500 frames): bf16 train steps whose MAS shape mas_fused cannot
    take, so each launches mas_wide; the path each step used against the
    plain version on the same inputs."""
    from vits_torch.config import load_hparams
    from vits_torch.models import synthesizer
    from vits_torch.models.synthesizer import build_synthesizer
    from vits_torch.ops import mas, mas_cuda
    from vits_torch.training.step import create_train_state, train_step
    from vits_torch.training.train import build_discriminator

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as phases 5 and 13
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    hps = load_hparams(config_path)
    hps.data.max_text_len = LONG_MAX_TEXT_LEN
    t_x = 2 * hps.data.max_text_len + 4  # training/train.py's text bound
    t_y = max(hps.data.bucket_boundaries)
    if mas_cuda.route(t_y, t_x) != "wide":
        raise AssertionError(f"long text: ({t_y}, {t_x}) is no shape for mas_wide")
    batch = synthetic_batch(hps, np.random.default_rng(seed + 14), torch.device("cuda"),
                            b=LONG_B, t_y=t_y, t_x=t_x, y_low=1000, x_low=400)
    bf16 = bool(hps.train.bf16_run)
    torch.manual_seed(seed)
    model = build_synthesizer(hps, bf16=bf16)
    disc = build_discriminator(hps, bf16, "cuda")
    state = create_train_state(model, disc, hps, steps_per_epoch=100)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = batch
    tb = dict(x=b["x"], t=b["t"], x_lengths=b["x_lengths"], spec=b["y"],
              spec_lengths=b["y_lengths"], ying=b["ying"], wav=b["wav"], sid=b["sid"])
    calls = []  # (neg_cent, mask, path) of every maximum_path call of the steps
    inner = synthesizer.maximum_path

    def recording(neg_cent, mask):
        path = inner(neg_cent, mask)
        calls.append((neg_cent.clone(), mask.clone(), path.clone()))
        return path

    n = LONG_WARMUP + LONG_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in mas_cuda.launches:
        mas_cuda.launches[k] = 0
    times, metrics = [], []
    synthesizer.maximum_path = recording
    try:
        for i in range(n):
            t0 = time.perf_counter()
            m = train_step(state, tb, hps, generator=gen)
            torch.cuda.synchronize()
            if i >= LONG_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
    finally:
        synthesizer.maximum_path = inner
    launches = dict(mas_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    recorded = sum(t.numel() * t.element_size() for c in calls for t in c)
    ms = (float(np.median(times)), min(times), max(times))
    print(f"{card} | long text: config_cje with max_text_len {hps.data.max_text_len}, B={LONG_B} "
          f"T_y={t_y} T_x={t_x} (frames {int(b['y_lengths'].min())}-{t_y}, symbols "
          f"{int(b['x_lengths'].min())}-{t_x}), bf16 {bf16}, segment {hps.train.segment_size}, "
          f"flagship D: median {ms[0]:.2f} ms (min {ms[1]:.2f}, max {ms[2]:.2f}, n={LONG_TIMED} "
          f"after {LONG_WARMUP} warm-up; host clock, synchronized) "
          + ", ".join(f"{t:.2f}" for t in times)
          + f" ms; peak memory {peak / 2**30:.2f} GiB ({recorded / 2**30:.2f} GiB of it the "
          f"recorded MAS inputs and paths); launches in {n} steps {launches}")
    for tag, m in (("first", metrics[0]), ("last", metrics[-1])):
        print(f"{card} | long text {tag} step: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    err = 0.0
    for i, (neg, mask, path) in enumerate(calls):
        if tuple(neg.shape) != (LONG_B, t_y, t_x):
            raise AssertionError(f"long text: MAS call {i} at {tuple(neg.shape)}")
        err = max(err, (path - mas.maximum_path_torch(neg, mask)).abs().max().item())
    print(f"{card} | long text: {len(calls)} maximum_path calls at ({LONG_B}, {t_y}, {t_x}) "
          f"against maximum_path_torch on the same inputs: max|err| {err}")
    if launches != mas_only(mas_wide=n):
        raise AssertionError(f"long text: mas_wide must launch once a step, {launches}")
    if len(calls) != n or err:
        raise AssertionError("long text: the step's path is not the plain version's")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("long text: a loss is not finite")
    neg, mask, _ = calls[-1]
    del state, model, disc, calls, batch, tb, b, m
    torch.cuda.empty_cache()
    kernel = (cuda_ms(lambda: mas_cuda.mas_wide(neg, mask), iters=10),
              cuda_ms(lambda: mas.maximum_path_torch(neg, mask), iters=2, warmup=1),
              mas_bound(mask[:, :, 0].sum(1), mask[:, 0, :].sum(1), t_y, t_x))
    print(f"{card} | long text: mas_wide on the last step's inputs {kernel[0]:.4f} ms, plain "
          f"{kernel[1]:.3f} ms, bound {kernel[2][0]:.5f} ms by {kernel[2][1]}")
    return dict(step_ms=ms, peak_bytes=peak, launches=launches, err=err, kernel=kernel,
                shape=(LONG_B, t_y, t_x), inputs=(neg, mask))


def jax_bench_lines(script: Path) -> list[dict]:
    """The JSON lines a JAX benchmark script prints, read from its source:
    {"metric": the "metric" literal or None, "keys": the set of keys} for
    each ``json.dumps`` of a dict literal, or of a name bound to one (with
    the keys the script adds to it by subscript assignment), in source
    order."""
    tree = ast.parse(script.read_text())
    built: dict[str, dict] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and isinstance(node.value, ast.Dict):
                built[target.id] = {"node": node.value, "extra": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            sub = node.targets[0]
            if isinstance(sub.value, ast.Name) and sub.value.id in built \
                    and isinstance(sub.slice, ast.Constant):
                built[sub.value.id]["extra"].add(sub.slice.value)
    lines = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args):
            continue
        arg, extra = node.args[0], set()
        if isinstance(arg, ast.Name) and arg.id in built:
            arg, extra = built[arg.id]["node"], built[arg.id]["extra"]
        if not isinstance(arg, ast.Dict):
            continue
        keys = {k.value for k in arg.keys}
        metric = next((v.value for k, v in zip(arg.keys, arg.values)
                       if k.value == "metric" and isinstance(v, ast.Constant)), None)
        lines.append((node.lineno, {"metric": metric, "keys": keys | extra}))
    return [line for _, line in sorted(lines, key=lambda item: item[0])]


BENCH_TIMEOUT_S = 420  # phase 15: each script's limit; ~1 minute each on an H100


def run_bench_script(card, script, args, jax_script, n_lines) -> tuple[list[dict], dict]:
    """Runs one benchmark script from the repo root; its JSON lines (held
    to the JAX script's keys, every number finite and > 0) and its last
    stderr record of train steps and MAS launches."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    print(f"{card} | bench {' '.join([script, *args])}: exit {proc.returncode} in {wall:.1f} s")
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"bench: {script} exited {proc.returncode}")
    err_lines = proc.stderr.strip().splitlines()
    for line in err_lines:
        if line.startswith(script):
            print(f"{card} | bench {line}")
    counted = next(json.loads(line) for line in reversed(err_lines)
                   if line.startswith('{"script": '))
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()[-n_lines:]]
    for line, ref in zip(lines, jax_bench_lines(ROOT / jax_script), strict=True):
        print(f"{card} | bench {script} {json.dumps(line)}")
        if set(line) != ref["keys"] or line.get("metric") != ref["metric"]:
            raise AssertionError(f"bench: {script}'s line {line.get('metric')} differs from "
                                 f"{jax_script}'s in {sorted(set(line) ^ ref['keys'])}")
        for k, v in line.items():
            number = isinstance(v, (int, float)) and not isinstance(v, bool)
            if v is None or number and not (np.isfinite(v) and v > 0):
                raise AssertionError(f"bench: {script}'s {k} is {v}")
    print(f"{card} | bench {script}: {counted['train_steps']} train steps, MAS launches "
          f"{counted['mas_launches']}")
    if counted["mas_launches"] != mas_only(mas_fused=counted["train_steps"]) \
            or not counted["train_steps"]:
        raise AssertionError(f"bench: {script} must launch mas_fused once a train step")
    return lines, counted["mas_launches"]


def check_bench(card, tmp: Path):
    """Phase 15: the port's benchmark scripts run as a user runs them."""
    kind = torch.cuda.get_device_name(0)
    launches = {}
    lines, launches["bench_torch"] = run_bench_script(card, "bench_torch.py", [], "bench.py", 1)
    line = lines[0]
    print(f"{card} | bench train step B={line['train_batch_size']} x 400 frames: "
          f"{line['train_flops_per_step'] / 1e12:.4f} TFLOP a step (step_flops), MFU "
          f"{line['train_mfu']:.6f} of the dense bf16 peak, peak memory "
          f"{line['train_hbm_bytes'] / 2**30:.2f} GiB")
    if not 0 < line["train_mfu"] <= 1 or not line["device"].startswith(kind):
        raise AssertionError(f"bench: train_mfu {line['train_mfu']}, device "
                             f"{line['device']!r} (card {kind!r})")
    _, launches["bench_train_torch"] = run_bench_script(card, "bench_train_torch.py", ["--bf16"],
                                                        "bench_train.py", 1)
    # traced apart, over 2 steps: 10 full-width steps make a trace of hundreds of MB
    trace_dir = tmp / "trace"
    _, launches["bench_train_torch_traced"] = run_bench_script(
        card, "bench_train_torch.py", ["--bf16", "--iters", "2", "--trace", str(trace_dir)],
        "bench_train.py", 1)
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel")
    print(f"{card} | bench bench_train_torch.py trace: {len(events)} events, {len(kernels)} "
          f"CUDA kernel events")
    if not kernels:
        raise AssertionError("bench: the trace holds no CUDA kernel event")
    busy, end = 0.0, kernels[0][0]
    for start, stop in kernels:  # the union of the kernels' intervals
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - kernels[0][0]
    print(f"{card} | bench bench_train_torch.py trace: kernels busy {busy / 1e3:.3f} ms of the "
          f"{span / 1e3:.3f} ms from the first kernel to the last, idle share "
          f"{1 - busy / span:.3f} (under the profiler, which stretches the host's side)")
    _, launches["bench_matrix_torch"] = run_bench_script(card, "bench_matrix_torch.py", [],
                                                         "bench_matrix.py", 6)
    return {"launches": launches}


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
    from vits_torch.ops import mas_cuda
    from vits_torch.utils.profiling import card_name

    card = card_name()
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
    serve = check_serve(card, str(ROOT / "configs" / "config_cje.yaml"), args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        run = check_train_run(card, str(ROOT / "configs" / "config_cje.yaml"), args.seed,
                              Path(tmp))
        ddp = {"cli": check_ddp_cli(card, Path(tmp), run),
               "two_ranks": check_ddp_two_ranks(card, Path(tmp), args.seed)}
    check_entry_and_host_mas(card, lengths)
    with tempfile.TemporaryDirectory() as tmp:
        tp = check_tp(card, str(ROOT / "configs" / "config_cje.yaml"), batch, Path(tmp),
                      args.seed)
        conv = check_convergence_tool(card, Path(tmp))
    check_bf16_card_against_cpu(card, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        migration = check_migration(card, str(ROOT / "configs" / "config_cje.yaml"), batch,
                                    args.seed, Path(tmp))
    del batch
    torch.cuda.empty_cache()
    long_text = check_long_text(card, str(ROOT / "configs" / "config_cje.yaml"), args.seed)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        bench = check_bench(card, Path(tmp))
    left = stop_descendants()
    print(f"{card} | processes left running by the phases: "
          f"{left if left else 'none'}")
    if left:
        raise AssertionError(f"the phases left {len(left)} process(es) running (now killed)")

    def on_paths(name):
        return {
            "launches_per_train_step": {
                "bf16": train[True]["launches"][name] / (TRAIN_WARMUP + TRAIN_TIMED),
                "f32": train[False]["launches"][name] / (TRAIN_WARMUP + TRAIN_TIMED),
            },
            "launches_per_forward": forward_launches[name],
            "launches_in_serve": serve["mas_launches"][name],
            # phase 8: the train CLI, 4 steps + 2 evaluations, then resumed for 4 more
            "launches_in_train_run": {k: run[k]["launches"][name] for k in ("train", "resume")},
            # phase 9: the CLI under torchrun (world 1, 4 steps + 2 evaluations) and each
            # of two ranks' one DDP step
            "launches_in_ddp": {
                "cli_world_1": ddp["cli"]["launches"][name],
                "two_ranks": [r[name] for r in ddp["two_ranks"]["launches"]],
            },
            # phase 10: each of four ranks' one step on the 2 x 2 (data, model) mesh
            "launches_in_tp": [r[name] for r in tp["launches"]],
            # phase 11: the convergence tool's train (one a step, one a validation batch)
            "launches_in_convergence": conv["launches"][name],
            # phase 13: the migrated generator served, then 4 fine-tune steps
            "launches_in_migration": migration["launches"][name],
            # phase 14: 1 + 3 long-text train steps, T_x 1024 x T_y 1500
            "launches_in_long_text": long_text["launches"][name],
            # phase 15: each benchmark script's train steps (one launch a step)
            "launches_in_bench": {k: v[name] for k, v in bench["launches"].items()},
        }

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
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, **on_paths(name),
        })
    kernels[0]["also_replaces"] = "vits_tpu/ops/mas_pallas.py:57"
    # the benchmark scripts' train shapes (phase 2)
    kernels[0]["at_bench"] = {"x".join(map(str, shape)): {"ms": t[0], "plain_ms": t[1],
                                                          "bound_ms": t[2][0]}
                              for shape, t in mas_rows["bench"].items()}
    # mas_wide replaces both as well, at the shapes mas_fused cannot take; its
    # path is phase 14's, and its times are on that path's last MAS inputs
    ms, plain_ms, (b_ms, b_by) = long_text["kernel"]
    kernels.append({
        "name": "mas_wide", "route": "cuda", "source": "vits_torch/csrc/mas.cu",
        "replaces": "vits_tpu/ops/mas_pallas.py:36",
        "also_replaces": "vits_tpu/ops/mas_pallas.py:57",
        "launches": long_text["launches"]["mas_wide"],
        "max_abs_err": max(mas_rows["err"]["mas_wide"], long_text["err"]), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": list(long_text["shape"]),
        "at": {"x".join(map(str, shape)): {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2][0]}
               for shape, t in mas_rows["wide"].items()},
        "plan": mas_cuda.wide_plan(*long_text["shape"],
                                   torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        # for the record: route keeps mas_fused at the main path's shape
        "at_main_against_fused": dict(zip(("ms", "fused_ms"), mas_rows["wide_at_main"])),
        **on_paths("mas_wide"),
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_descendants(wait_s=0.0)  # a failed phase may leave workers
    sys.exit(rc)
