#!/usr/bin/env python3
"""Where the time of mas_wide_kernel goes, on one NVIDIA card.

Builds copies of vits_torch/csrc/mas.cu with %globaltimer stamps at the
phase boundaries of the wide kernel (entry, the lengths published, each DP
warp's first and last row, the copy warp's last copy, the zero fill, the
last cluster barrier, the walk) into vits_torch/_build/, one copy a variant,
runs each at the given shapes with random scores from a seed (full lengths),
checks the path against the plain version where the variant keeps the
algorithm, and prints for each the kernel's time by CUDA events and the
phases in microseconds, averaged over the items (a DP warp's time also per
row), with the card's name and power limit.

    python3 tools/probe_mas_wide.py [--variant V ...] [--shape B,T_y,T_x ...]

A variant is tokens joined by '+': base (the source as it is); depth16
(handover rings of 16 groups); g8 (8 rows a handover); k4, k1 (4 or 1
columns a lane, 2 or 8 DP warps a block); testwait (mbarrier.test_wait for
try_wait); fill2 (two fill warps); r32 (32 rows a stage); nofill (no zero fill: the path is wrong); nostore, noballot (no
decision words stored, or none made: the path is wrong); nowalk (no walk: the path
is wrong); cycles (SM cycles a row of each DP warp's group loop by part: the
stage wait, the handover in, the rows with their scores' loads, the
handover out). The stamps cost a few instructions a phase, not a row
(cycles: four clock reads a group).
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

SLOTS = 24  # stamps a block
MAX_BLOCKS = 1024
PROBE = (
    "__device__ unsigned long long g_probe[{blocks} * {slots}];\n"
    "__device__ long long g_acc[{blocks} * 32];\n"
    "#define PROBE(i) do {{ unsigned long long t_; "
    'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
    "g_probe[blockIdx.x * {slots} + (i)] = t_; }} while (0)\n"
)
# (anchor, text, before): the stamp goes after the anchor, or before it
STAMPS = [
    ("  const int b = blockIdx.x / C;\n", "  if (threadIdx.x == 0) PROBE(0);\n", False),
    ("  cluster_sync();  // the mbarriers initialised cluster-wide, the counts published\n",
     "  if (tid == 0) PROBE(1);\n", False),
    ("      for (int g = 0; g < groups; ++g) {\n", "      if (lane == 0) PROBE(2 + warp);\n", True),
    ("    if (active) chunk_base += chunks;\n",
     "    if (warp < W && lane == 0) PROBE(10 + warp);\n"
     "    if (warp == W && lane == 0) PROBE(18);\n", True),
    ("  int chunk_base = 0;          // chunks of the block's earlier stripes\n",
     "  if (warp == W + 1 && lane == 0) PROBE(19);\n", True),
    ("  if (rank != 0 || warp != 0 || stripes == 0) return;\n", "  if (tid == 0) PROBE(20);\n", True),
]
WALK_END = ("    col = lo + rel;\n  }\n}\n",
            "    col = lo + rel;\n  }\n  if (lane == 0) PROBE(21);\n}\n")
STORE = "  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);\n"  # store_words
VARIANTS = {
    "base": [],
    "depth16": [("constexpr int kWideDepth = 4;", "constexpr int kWideDepth = 16;")],
    "g8": [("constexpr int kWideGroup = 16;", "constexpr int kWideGroup = 8;")],
    "k4": [("constexpr int kWideLaneCols = 2;", "constexpr int kWideLaneCols = 4;"),
           ("constexpr int kWidePlanWarps = 4;", "constexpr int kWidePlanWarps = 2;"),
           ("return ((T_x + 31) / 32 + 1) & ~1;", "return ((T_x + 31) / 32 + 3) & ~3;"),
           (STORE, "  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);\n")],
    "k1": [("constexpr int kWideLaneCols = 2;", "constexpr int kWideLaneCols = 1;"),
           ("constexpr int kWidePlanWarps = 4;", "constexpr int kWidePlanWarps = 8;"),
           (STORE, "  p[0] = w[0];\n")],
    "testwait": [('    if (tries == (1u << 24)) __trap();\n    asm volatile(\n'
                  '        "{\\n\\t.reg .pred p;\\n\\t"\n'
                  '        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;',
                  '    if (tries == (1u << 24)) __trap();\n    asm volatile(\n'
                  '        "{\\n\\t.reg .pred p;\\n\\t"\n'
                  '        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;')],
    "fill2": [("constexpr int kWideFillWarps = 1;", "constexpr int kWideFillWarps = 2;")],
    "r32": [("constexpr int kWideStageRows = 16;", "constexpr int kWideStageRows = 32;")],
    "nofill": [("    if (start < cells)\n      zero_fill(", "    if (false)\n      zero_fill(")],
    "nostore": [("      if (lane == 0) store_words(drow + (size_t)j * dec_words, word);\n", "")],
    "noballot": [("    word[c] = __ballot_sync(kFull, v[c] < s);\n", "    word[c] = 0u;\n")],
    "nowalk": [("  if (rank != 0 || warp != 0 || stripes == 0) return;\n", "  return;\n")],
}
# cycles: SM cycles of each DP warp's group loop by part, summed over groups
VARIANTS["cycles"] = [
    ("      for (int g = 0; g < groups; ++g) {\n",
     "      long long acc_[4] = {0, 0, 0, 0}, c0_, c1_, c2_, c3_;\n"
     "      for (int g = 0; g < groups; ++g) {\n        c0_ = clock64();\n"),
    ("        const unsigned char* rows = ring + (size_t)(stage * R + gi * G) * slot;\n",
     "        c1_ = clock64(); acc_[0] += c1_ - c0_;\n"
     "        const unsigned char* rows = ring + (size_t)(stage * R + gi * G) * slot;\n"),
    ("        float out[G];  // this warp's last column at rows t0 .. t0 + G - 1\n",
     "        c2_ = clock64(); acc_[1] += c2_ - c1_;\n"
     "        float out[G];  // this warp's last column at rows t0 .. t0 + G - 1\n"),
    ("        carry = e[G - 1];\n",
     "        c3_ = clock64(); acc_[2] += c3_ - c2_;\n        carry = e[G - 1];\n"),
    ("        if (last && (gi == R / G - 1 || g + 1 == groups)) {\n",
     "        acc_[3] += clock64() - c3_;\n"
     "        if (last && (gi == R / G - 1 || g + 1 == groups)) {\n"),
    ("      }\n    }\n    if (warp < W && lane == 0) PROBE(10 + warp);\n",
     "      }\n      if (lane == 0) for (int i_ = 0; i_ < 4; ++i_) "
     "g_acc[blockIdx.x * 32 + warp * 4 + i_] = acc_[i_];\n"
     "    }\n    if (warp < W && lane == 0) PROBE(10 + warp);\n"),
]


def edits_of(variant: str) -> list:
    """A variant is tokens of VARIANTS joined by '+', e.g. k1+g16+cycles."""
    return [e for token in variant.split("+") for e in VARIANTS[token]]


def source(variant: str) -> str:
    src = (ROOT / "vits_torch" / "csrc" / "mas.cu").read_text()
    head = "constexpr unsigned kFull = 0xffffffffu;\n"
    edits = [(head, head + PROBE.format(blocks=MAX_BLOCKS, slots=SLOTS))]
    edits += [(a, t + a if before else a + t) for a, t, before in STAMPS] + [WALK_END]
    for anchor, text in edits + edits_of(variant):
        if src.count(anchor) != 1:
            raise RuntimeError(f"mas.cu changed: anchor {anchor!r} not found once")
        src = src.replace(anchor, text)
    helpers = (
        'extern "C" {\n'
        "int probe_read(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n"
        "int probe_acc(long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, g_acc, sizeof(g_acc));\n}\n"
        "int probe_clear() {\n"
        "  static unsigned long long zeros[sizeof(g_probe) / 8];\n"
        "  return (int)cudaMemcpyToSymbol(g_probe, zeros, sizeof(g_probe));\n}\n"
    )
    return src.replace('extern "C" {\n', helpers, 1)


def build(variants) -> dict:
    """One library a variant, all nvcc processes started together."""
    from vits_torch import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for v in variants:
        cu = _build.BUILD_DIR / f"mas_wide_probe_{v}.cu"
        so = _build.BUILD_DIR / f"libmas_wide_probe_{v}.so"
        cu.write_text(source(v))
        procs[v] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mas_wide.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.mas_wide.restype = i
        lib.probe_read.argtypes = [p]
        lib.probe_read.restype = i
        lib.probe_clear.restype = i
        lib.probe_acc.argtypes = [p]
        lib.probe_acc.restype = i
        lib.mas_wide_plan.argtypes = [i, i, i, i, p]
        lib.mas_wide_plan.restype = i
        libs[v] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", help="tokens joined by '+': " + ", ".join(VARIANTS))
    ap.add_argument("--shape", action="append", help="B,T_y,T_x (full lengths)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mas_wide: no CUDA device", file=sys.stderr)
        return 2
    from vits_torch.ops import mas, mas_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    variants = args.variant or ["base"]
    shapes = [tuple(map(int, s.split(","))) for s in args.shape or ["16,1500,1024"]]
    libs = build(variants)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(args.seed)
    for b, t_y, t_x in shapes:
        neg = torch.from_numpy(rng.standard_normal((b, t_y, t_x)).astype(np.float32)).cuda()
        mask = torch.ones_like(neg)
        ref = mas.maximum_path_torch(neg, mask)
        path = torch.empty_like(neg)
        # rows padded to 4 words: the most any variant's rows take (k4's)
        dec = torch.empty((b, t_y, -(-t_x // 128) * 4), dtype=torch.uint32, device="cuda")
        edge = torch.empty((2, b, t_y), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for v, lib in libs.items():
            out = (ctypes.c_longlong * 8)()
            lib.mas_wide_plan(b, t_y, t_x, sms, out)
            plan = mas_cuda.WidePlan(*out)

            def run():
                err = lib.mas_wide(neg.data_ptr(), mask.data_ptr(), path.data_ptr(), dec.data_ptr(),
                                   edge.data_ptr(), b, t_y, t_x, stream)
                if err:
                    raise RuntimeError(f"mas_wide launch failed: cudaError {err}")

            # no variant may read the path or decisions an earlier one left
            path.fill_(float("nan"))
            dec.zero_()
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            exact = torch.equal(path, ref)
            if not set(v.split("+")) & {"nofill", "nowalk", "nostore", "noballot"} and not exact:
                raise AssertionError(f"variant {v} disagrees with the plain version")
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                run()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / 20
            lib.probe_clear()
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
            if lib.probe_read(ctypes.addressof(buf)):
                raise RuntimeError("probe_read failed")
            s = np.array(buf, dtype=np.float64).reshape(MAX_BLOCKS, SLOTS)[: b * plan.cluster]
            s = s.reshape(b, plan.cluster, SLOTS)
            t_start = s[:, :, 0].min()
            rel = lambda a: (a - t_start) / 1e3  # noqa: E731  (us from the first block's entry)
            c0 = s[:, 0]
            line = [f"{card} | mas_wide {v} B={b} T_y={t_y} T_x={t_x} plan {tuple(plan)}: "
                    f"kernel {ms:.4f} ms (exact {exact}); us from the first entry, mean over items:"]
            line.append(f"entry {np.mean(rel(s[:, :, 0])):.2f} (last {np.max(rel(s[:, :, 0])):.2f}), "
                        f"lengths published {np.mean(rel(s[:, :, 1])):.2f}")
            for r in range(plan.cluster):
                for w in range(plan.warps):
                    first, last = s[:, r, 2 + w], s[:, r, 10 + w]
                    ok = (first > 0) & (last > 0)
                    if ok.any():
                        line.append(f"block {r} warp {w}: rows {np.mean(rel(first[ok])):.2f} -> "
                                    f"{np.mean(rel(last[ok])):.2f} "
                                    f"({np.mean((last[ok] - first[ok]) / (t_y - 1)):.1f} ns a row)")
            line.append(f"copies done {np.mean(rel(s[:, :, 18])):.2f}, fill done "
                        f"{np.mean(rel(s[:, :, 19])):.2f} (last {np.max(rel(s[:, :, 19])):.2f}), "
                        f"last barrier {np.mean(rel(c0[:, 20])):.2f}, walk done "
                        f"{np.mean(rel(c0[:, 21])):.2f} (last {np.max(rel(c0[:, 21])):.2f}; "
                        f"walk {np.mean((c0[:, 21] - c0[:, 20]) / 1e3):.2f})")
            if "cycles" in v.split("+"):
                acc = (ctypes.c_longlong * (MAX_BLOCKS * 32))()
                lib.probe_acc(ctypes.addressof(acc))
                a = np.array(acc, dtype=np.float64).reshape(MAX_BLOCKS, 8, 4)[: b * plan.cluster]
                a = a.reshape(b, plan.cluster, 8, 4) / (t_y - 1)
                for r in range(plan.cluster):
                    for w in range(plan.warps):
                        m = a[:, r, w].mean(0)
                        line.append(f"block {r} warp {w} cycles a row: stage wait {m[0]:.1f}, "
                                    f"in {m[1]:.1f}, rows {m[2]:.1f}, out {m[3]:.1f}")
            print("\n    ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
