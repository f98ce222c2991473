#!/usr/bin/env python3
"""Where the cycles of mas_fused_kernel go, on one NVIDIA card.

Builds a copy of vits_torch/csrc/mas.cu with clock64() stamps at the phase
boundaries of the fused kernel (lengths counted, DP done, walk done) into
vits_torch/_build/, runs it at the main path's MAS shapes with random scores
and lengths from a seed, checks the path against the plain version, and
prints for each shape the SM cycles of each phase (per row for the DP and the
walk, over the items' t_y), the kernel's time by CUDA events, and the card's
name and power limit.

    python3 tools/probe_mas_fused.py [--seed N]

The stamps cost a few instructions per phase, not per row.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = [(16, 400, 191), (32, 800, 384), (64, 1500, 384)]
STAMPS = [  # (anchor in mas.cu, where, stamp): the stamp goes after the anchor
    ("  const bool walk = ty > 0 && tx > 0;\n", "  if (tid == 0) PROBE(0);\n"),
    ("      consumed = nchunks;\n", "      if (lane == 0) PROBE(1);\n"),
    ("  if (warp != 0 || !walk) return;\n", "  if (lane == 0) PROBE(2);\n"),
    ("    idx = lo + rel;\n  }\n", "  if (lane == 0) PROBE(3);\n"),
]
START = ("  const int early = min(kStages, (T_y + R - 1) / R);\n", "  if (tid == 0) PROBE(4);\n")


def stamped_source() -> str:
    src = (ROOT / "vits_torch" / "csrc" / "mas.cu").read_text()
    head = "constexpr unsigned kFull = 0xffffffffu;\n"
    probe = (
        "__device__ long long g_probe[256 * 8];\n"
        "#define PROBE(i) g_probe[blockIdx.x * 8 + (i)] = clock64()\n"
    )
    for anchor, text in [(head, probe), START, *STAMPS]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"mas.cu changed: anchor {anchor!r} not found once")
        src = src.replace(anchor, anchor + text)
    read = (
        'extern "C" {\nint probe_read(long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(long long) * 256 * 8);\n}\n"
    )
    return src.replace('extern "C" {\n', read, 1)


def build() -> ctypes.CDLL:
    from vits_torch import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    cu = _build.BUILD_DIR / "mas_probe.cu"
    so = _build.BUILD_DIR / "libmas_probe.so"
    cu.write_text(stamped_source())
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_fused.argtypes = [p, p, p, i, i, i, p]
    lib.mas_fused.restype = i
    lib.probe_read.argtypes = [p]
    lib.probe_read.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mas_fused: no CUDA device", file=sys.stderr)
        return 2
    from vits_torch.ops import mas

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lib = build()
    rng = np.random.default_rng(args.seed)
    for b, t_y, t_x in SHAPES:
        t_xs = rng.integers(2, t_x + 1, size=b)
        t_ys = np.maximum(rng.integers(t_x, t_y + 1, size=b), t_xs)
        mask = ((np.arange(t_y)[None, :, None] < t_ys[:, None, None])
                & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])).astype(np.float32)
        neg = torch.from_numpy(rng.standard_normal((b, t_y, t_x)).astype(np.float32)).cuda()
        mask = torch.from_numpy(mask).cuda()
        path = torch.empty_like(neg)
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.mas_fused(neg.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_y, t_x, stream)
            if err:
                raise RuntimeError(f"mas_fused launch failed: cudaError {err}")

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        if not torch.equal(path, mas.maximum_path_torch(neg, mask)):
            raise AssertionError("stamped mas_fused disagrees with the plain version")
        buf = (ctypes.c_longlong * (256 * 8))()
        if lib.probe_read(ctypes.addressof(buf)):
            raise RuntimeError("probe_read failed")
        s = np.array(buf).reshape(256, 8)[:b].astype(np.float64)
        start, lengths, dp, walk0, walk1 = s[:, 4], s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        ty = t_ys.astype(np.float64)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            run()
        t1.record()
        torch.cuda.synchronize()
        print(f"{card} | mas_fused B={b} T_y={t_y} T_x={t_x}: kernel {t0.elapsed_time(t1) / 20:.4f} ms; "
              f"SM cycles, mean over items: lengths {np.mean(lengths - start):.0f}, "
              f"DP {np.mean(dp - lengths):.0f} ({np.mean((dp - lengths) / ty):.1f} a row), "
              f"barrier {np.mean(walk0 - dp):.0f}, walk {np.mean(walk1 - walk0):.0f} "
              f"({np.mean((walk1 - walk0) / ty):.1f} a row), block {np.mean(walk1 - start):.0f}; "
              f"longest item {np.max(walk1 - start):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
