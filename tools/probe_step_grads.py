#!/usr/bin/env python3
"""Which loss carries the card-against-CPU gap of the train step's gradients.

Runs chip_smoke.py's tiny train step (probe discriminator, f32, TF32 off,
cuDNN deterministic, dropout off) on the CPU and on the card from the same
weights and draws: once with every loss, then with the yin losses, the mel
loss, and both weighted 0. For each run it prints the largest per-tensor
gradient gaps relative to the tensor's norm (tensors whose gap is below
1e-6 of the global norm are at the noise floor and skipped) and the worst
gap of each group: the generator's waveform decoder, the rest of the
generator, the discriminator.

    python3 tools/probe_step_grads.py [--seed N] [--top N]

Needs a CUDA device. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the tiny step pair and the card line)

RUNS = ({}, {"c_yin": 0.0}, {"c_mel": 0.0}, {"c_yin": 0.0, "c_mel": 0.0})


def gradient_gaps(states, metrics):
    """[(relative gap, name, group)] of every tensor above the noise floor."""
    (s_cpu, s_gpu), (m_cpu, _) = states, metrics
    rows = []
    for side, norm_key in (("model", "grad_norm/g"), ("disc", "grad_norm/d")):
        total = m_cpu[norm_key].item()
        for (k, p_cpu), p_gpu in zip(getattr(s_cpu, side).named_parameters(),
                                     getattr(s_gpu, side).parameters()):
            err = (p_gpu.grad.cpu() - p_cpu.grad).norm().item()
            if err <= 1e-6 * total:
                continue
            group = ("discriminator" if side == "disc" else
                     "decoder" if k.startswith("waveform_decoder.") else "generator rest")
            rows.append((err / p_cpu.grad.norm().item(), f"{side}.{k}", group))
    return sorted(rows, reverse=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_step_grads: needs a CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    for train in RUNS:
        _, states, metrics, _ = chip_smoke.tiny_train_step_pair(args.seed, **train)
        rows = gradient_gaps(states, metrics)
        label = ", ".join(f"{k}={v}" for k, v in train.items()) or "every loss"
        worst = {}
        for rel, _, group in rows:
            worst[group] = max(worst.get(group, 0.0), rel)
        print(f"{card} | {label}: worst relative gradient gap by group: "
              + ", ".join(f"{g} {v:.3e}" for g, v in sorted(worst.items())))
        for rel, name, _ in rows[:args.top]:
            print(f"{card} | {label}   {rel:.3e} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
