"""The card's published peaks and the MAS byte bound (frozen copies of the
program's ``utils/profiling.py`` peak table and of ``chip_smoke.py``'s
``mas_bound``).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989e12
FLOP/s in bf16 on the tensor cores, 67e12 FLOP/s in float32 outside them,
3.35e12 bytes/s of HBM. A card below 700 W runs slower under load: its
power limit is written beside every share stated against these peaks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
_PEAK_BF16_FLOPS = (("H100 80GB HBM3", 989e12), ("H100 SXM", 989e12))


def peak_bf16_flops(name: str) -> float | None:
    """Dense bf16 peak FLOP/s of the card ``name`` names, else None."""
    for key, peak in _PEAK_BF16_FLOPS:
        if key in name:
            return peak
    return None


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and float32 operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def mas_bound_s(ty, tx, t_y: int, t_x: int) -> float:
    """The bound of one ``maximum_path`` over a [B, T_y, T_x] lattice whose
    items have ``ty`` frames and ``tx`` symbols (sequences of ints), whatever
    kernel computes it: read the scores inside the rectangles and the mask's
    first column and row, write the whole float32 path; an add, a max and a
    compare a cell."""
    b = len(ty)
    cells = float(sum(int(a) * int(c) for a, c in zip(ty, tx)))
    return bound_s(4 * cells + 4.0 * b * (t_y + t_x) + 4.0 * b * t_y * t_x, 3 * cells)
