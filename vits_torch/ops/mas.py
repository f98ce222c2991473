"""Monotonic Alignment Search (port of ``vits_tpu/ops/mas.py``).

Algorithm (per sample, value lattice [T_y frames, T_x text]):
  forward:   value[y, x] = neg[y, x] + max(value[y-1, x], value[y-1, x-1]),
             row 0 is neg[0] with -1e9 added off column 0, masked cells are
             -1e9; the decision dec[y, x] = value[y-1, x] < value[y-1, x-1]
             is all the backtrack needs.
  backtrack: from (t_y-1, t_x-1) down to row 0; the column steps left where
             it equals the row or the decision at the current cell is set,
             and never below 0.

Two implementations with the JAX package's layout ([B, T_y, T_x]):
  * the plain PyTorch version here (``mas_decisions`` + ``mas_backtrack``),
    a row loop that repeats the JAX ``maximum_path_scan`` arithmetic;
  * the CUDA kernels in ``vits_torch/csrc/mas.cu`` (``ops/mas_cuda.py``):
    ``mas_fused`` and ``mas_wide``, each one launch for the whole search, and
    the first port's pair ``mas_forward`` + ``mas_backtrack``, which no path
    runs.

``maximum_path`` takes the plain version only for a CPU tensor. A CUDA
tensor launches the kernel that ``mas_cuda.route`` names for its shape
(``mas_fused`` where its decisions fit in shared memory, ``mas_wide``
everywhere else), or raises. There is no fallback between them. Like the JAX
``maximum_path`` it takes any float dtype and any layout: the inputs are
cast to f32 and copied where the kernels need it, and the path comes back in
the dtype of ``path.to(neg_cent.dtype) * mask``.
"""

from __future__ import annotations

import torch

from vits_torch.ops import mas_cuda
from vits_torch.utils.profiling import span

BIG_NEG = -1e9


def mas_decisions(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Forward DP. neg_cent, mask: [B, T_y, T_x] -> decisions uint8, same
    shape (row 0 is all zero)."""
    neg = torch.where(mask > 0, neg_cent.to(torch.float32), BIG_NEG)
    b, t_y, t_x = neg.shape
    dec = torch.zeros((b, t_y, t_x), dtype=torch.uint8, device=neg.device)
    col0 = torch.full((b, 1), BIG_NEG, dtype=torch.float32, device=neg.device)
    off_col0 = torch.full((t_x,), BIG_NEG, dtype=torch.float32, device=neg.device)
    off_col0[0] = 0.0
    prev = neg[:, 0] + off_col0
    for y in range(1, t_y):
        shifted = torch.cat([col0, prev[:, :-1]], dim=1)
        dec[:, y] = prev < shifted
        prev = neg[:, y] + torch.maximum(prev, shifted)
    return dec


def mas_backtrack(
    dec: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor
) -> torch.Tensor:
    """Walk the decisions. dec: [B, T_y, T_x]; t_ys, t_xs: [B] -> path f32."""
    b, t_y, t_x = dec.shape
    t_ys = t_ys.to(torch.long)
    t_xs = t_xs.to(torch.long)
    path = torch.zeros((b, t_y, t_x), dtype=torch.float32, device=dec.device)
    rows = torch.arange(b, device=dec.device)
    idx = torch.zeros((b,), dtype=torch.long, device=dec.device)
    for y in range(t_y - 1, -1, -1):
        idx = torch.where(t_ys - 1 == y, t_xs - 1, idx)
        active = (t_ys > y) & (t_xs > 0)  # no columns: no walk, as in the kernel
        path[rows, y, idx] = active.to(torch.float32)
        step = (idx == y) | dec[rows, y, idx].bool()
        idx = torch.where(active & (idx != 0) & step, idx - 1, idx)
    return path


def maximum_path_torch(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MAS. neg_cent, mask: [B, T_y, T_x] -> hard path in
    neg_cent's dtype."""
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32)
    path = mas_backtrack(mas_decisions(neg_cent, mask), t_ys, t_xs)
    return path.to(neg_cent.dtype) * mask


def kernel_inputs(
    neg_cent: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """neg_cent and mask as the kernels take them: f32, contiguous, neg_cent
    on a 16-byte boundary (``mas_fused``'s bulk copies). Casts and copies only
    where the input is not so already."""
    neg = neg_cent.to(torch.float32).contiguous()
    if neg.data_ptr() % 16:
        neg = neg.clone()
    return neg, mask.to(torch.float32).contiguous()


@torch.no_grad()
def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAS: a CUDA kernel chosen by shape for a CUDA tensor, the plain version
    for a CPU tensor. neg_cent, mask: [B, T_y, T_x] (frames x text) -> hard
    path (span ``mas``)."""
    with span("mas"):
        if neg_cent.device.type == "cuda":
            neg, m = kernel_inputs(neg_cent, mask)
            _, t_y, t_x = neg.shape
            route = mas_cuda.route(t_y, t_x)
            kernel = mas_cuda.mas_fused if route == "fused" else mas_cuda.mas_wide
            return kernel(neg, m).to(torch.promote_types(neg_cent.dtype, mask.dtype))
        if neg_cent.device.type == "cpu":
            return maximum_path_torch(neg_cent, mask)
    raise ValueError(f"maximum_path: no implementation on {neg_cent.device}")
