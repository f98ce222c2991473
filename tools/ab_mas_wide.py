#!/usr/bin/env python3
"""mas_wide against another tree's, in turns on one NVIDIA card.

Builds the other tree's vits_torch/csrc/mas.cu (for example the parent
commit's, unpacked with `git archive`) into a second library beside this
tree's, and times the two mas_wide launches in turns (other, this, this,
other; CUDA events, 20 launches each) on the same inputs: the shapes of
chip_smoke.py's WIDE_TIMED at full lengths, then the last MAS inputs of
chip_smoke.py's phase 14 (the long-text train step, which it runs). Both
paths are checked against maximum_path_torch first. Prints each pair of
times with the corrected bytes bound (chip_smoke.mas_bound), the phase-14
step's times and mas_wide's share of it, and the card's name and power
limit.

    git archive HEAD~1 vits_torch/csrc | tar -x -C _chip_scratch/parent
    python3 tools/ab_mas_wide.py --other _chip_scratch/parent

The other tree's C entry point must take mas_wide's arguments (neg, mask,
path, dec, edge, B, T_y, T_x, stream); its decision scratch is allocated
with rows of ceil(T_x / 32) words padded to 4, as many as any layout of
the kernel so far writes a row.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_other(tree: Path) -> ctypes.CDLL:
    from vits_torch import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    so = _build.BUILD_DIR / "libmas_other.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(tree / "vits_torch" / "csrc" / "mas.cu")],
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mas_wide.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.mas_wide.restype = i
    return lib


def other_wide(lib, neg, mask):
    b, t_y, t_x = neg.shape
    path = torch.empty_like(neg)
    # rows of ceil(T_x / 32) words padded to 4: never fewer than the other
    # kernel's own stride (ceil(T_x / 32), or padded to 2 or 4)
    dec = torch.empty((b, t_y, -(-t_x // 128) * 4), dtype=torch.uint32, device=neg.device)
    edge = torch.empty((2, b, t_y), device=neg.device)
    err = lib.mas_wide(neg.data_ptr(), mask.data_ptr(), path.data_ptr(), dec.data_ptr(),
                       edge.data_ptr(), b, t_y, t_x, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other tree's mas_wide launch failed: cudaError {err}")
    return path


def in_turns(card, label, neg, mask, lib):
    import chip_smoke as cs
    from vits_torch.ops import mas, mas_cuda

    ref = mas.maximum_path_torch(neg, mask)
    old, new = other_wide(lib, neg, mask), mas_cuda.mas_wide(neg, mask)
    torch.cuda.synchronize()
    if not (torch.equal(old, ref) and torch.equal(new, ref)):
        raise AssertionError(f"{label}: a kernel disagrees with the plain version")
    t = [cs.cuda_ms(lambda: other_wide(lib, neg, mask), iters=20),
         cs.cuda_ms(lambda: mas_cuda.mas_wide(neg, mask), iters=20),
         cs.cuda_ms(lambda: mas_cuda.mas_wide(neg, mask), iters=20),
         cs.cuda_ms(lambda: other_wide(lib, neg, mask), iters=20)]
    b_ms, _ = cs.mas_bound(mask[:, :, 0].sum(1), mask[:, 0, :].sum(1), *neg.shape[1:])
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"{card} | {label}: in turns other {t[0]:.4f}, this {t[1]:.4f}, this {t[2]:.4f}, "
          f"other {t[3]:.4f} ms; this {n:.4f} against other {o:.4f} ms ({o / n:.2f}x); "
          f"bytes bound {b_ms:.5f} ms (this {n / b_ms:.2f}x it)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's root")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_mas_wide: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vits_torch import _build
    from vits_torch.utils.profiling import card_name

    card = card_name()
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build(["mas"])
    lib = build_other(args.other)
    for b, t_y, t_x in cs.WIDE_TIMED:
        neg, mask, _, _ = cs.mas_case(b, t_y, t_x, 7, [t_y] * b, [t_x] * b)
        in_turns(card, f"({b}, {t_y}, {t_x}) full lengths", neg, mask, lib)
        del neg, mask
    out = cs.check_long_text(card, str(ROOT / "configs" / "config_cje.yaml"), args.seed)
    neg, mask = out["inputs"]
    in_turns(card, f"phase 14's last MAS inputs {tuple(neg.shape)}", neg, mask, lib)
    step = out["step_ms"][0]
    print(f"{card} | phase 14 step median {step:.2f} ms (min {out['step_ms'][1]:.2f}, max "
          f"{out['step_ms'][2]:.2f}); mas_wide {out['kernel'][0]:.4f} ms, "
          f"{out['kernel'][0] / step * 100:.3f}% of it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
